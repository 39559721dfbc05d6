"""BN254 (alt_bn128) in plain Python integers: Fr and Fq, G1 in Jacobian
coordinates, arkworks' compressed point encoding, RFC 9380's
expand_message_xmd over SHA-256, hash-to-Fr, the SHA-256 try-and-increment
point generator and the Fiat-Shamir transcript of SleepingShell/verkle-kzg
(``vector-commit/src/transcript.rs``, ``ipa/ipa_point_generator.rs``).

The benchmark's reference: it imports nothing of the program under test.
The constants are the published ones (EIP-196, EIP-197). G1 points leave
every function as affine ``(x, y)`` int tuples, ``None`` at infinity.
"""

from __future__ import annotations

import hashlib

#: Base field modulus q and scalar field modulus r (EIP-196).
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
B = 3
G1 = (1, 2)

#: Fr's multiplicative generator and two-adicity (arkworks' ark_bn254::Fr).
FR_GENERATOR = 5
FR_TWO_ADICITY = 28

_INF = (1, 1, 0)


def root_of_unity(n: int) -> int:
    """The generator of the n-th roots of unity that arkworks' radix-2
    domain uses: 5^((r - 1) / 2^28) raised to 2^28 / n."""
    log = n.bit_length() - 1
    assert n == 1 << log and log <= FR_TWO_ADICITY
    return pow(pow(FR_GENERATOR, (R - 1) >> FR_TWO_ADICITY, R), 1 << (FR_TWO_ADICITY - log), R)


def domain(n: int) -> list:
    """[w^0, ..., w^(n-1)] of the size-n radix-2 domain."""
    w = root_of_unity(n)
    out = [1] * n
    for i in range(1, n):
        out[i] = out[i - 1] * w % R
    return out


def batch_inverse(xs: list, m: int = R) -> list:
    """Montgomery's trick; zeros stay zero (arkworks' ``batch_inversion``)."""
    prefix, acc = [], 1
    for x in xs:
        prefix.append(acc)
        if x % m:
            acc = acc * x % m
    inv = pow(acc, m - 2, m)
    out = list(xs)
    for i in range(len(xs) - 1, -1, -1):
        if xs[i] % m:
            out[i] = inv * prefix[i] % m
            inv = inv * xs[i] % m
    return out


# ---------------------------------------------------------------------------
# G1, y^2 = x^3 + 3 over Fq, Jacobian (X, Y, Z): x = X / Z^2, y = Y / Z^3
# ---------------------------------------------------------------------------


def jac(a) -> tuple:
    return _INF if a is None else (a[0], a[1], 1)


def jdouble(p: tuple) -> tuple:
    x, y, z = p
    if z == 0 or y == 0:
        return _INF
    a = x * x % Q
    b = y * y % Q
    c = b * b % Q
    d = 2 * ((x + b) * (x + b) - a - c) % Q
    e = 3 * a % Q
    x3 = (e * e - 2 * d) % Q
    return x3, (e * (d - x3) - 8 * c) % Q, 2 * y * z % Q


def jadd(p: tuple, q: tuple) -> tuple:
    x1, y1, z1 = p
    x2, y2, z2 = q
    if z1 == 0:
        return q
    if z2 == 0:
        return p
    z1z1 = z1 * z1 % Q
    z2z2 = z2 * z2 % Q
    u1 = x1 * z2z2 % Q
    u2 = x2 * z1z1 % Q
    s1 = y1 * z2 * z2z2 % Q
    s2 = y2 * z1 * z1z1 % Q
    if u1 == u2:
        return jdouble(p) if s1 == s2 else _INF
    h = (u2 - u1) % Q
    rr = (s2 - s1) % Q
    hh = h * h % Q
    hhh = h * hh % Q
    v = u1 * hh % Q
    x3 = (rr * rr - hhh - 2 * v) % Q
    return x3, (rr * (v - x3) - s1 * hhh) % Q, z1 * z2 * h % Q


def jmadd(p: tuple, a) -> tuple:
    """p + a for an affine a."""
    if a is None:
        return p
    x1, y1, z1 = p
    if z1 == 0:
        return a[0], a[1], 1
    z1z1 = z1 * z1 % Q
    u2 = a[0] * z1z1 % Q
    s2 = a[1] * z1 * z1z1 % Q
    if u2 == x1:
        return jdouble(p) if s2 == y1 else _INF
    h = (u2 - x1) % Q
    rr = (s2 - y1) % Q
    hh = h * h % Q
    hhh = h * hh % Q
    v = x1 * hh % Q
    x3 = (rr * rr - hhh - 2 * v) % Q
    return x3, (rr * (v - x3) - y1 * hhh) % Q, z1 * h % Q


def jneg(p: tuple) -> tuple:
    return p[0], (-p[1]) % Q, p[2]


def to_affine(p: tuple):
    return batch_to_affine([p])[0]


def batch_to_affine(ps: list) -> list:
    zinv = batch_inverse([p[2] for p in ps], Q)
    out = []
    for (x, y, z), zi in zip(ps, zinv):
        if z == 0:
            out.append(None)
            continue
        zi2 = zi * zi % Q
        out.append((x * zi2 % Q, y * zi2 * zi % Q))
    return out


def add(a, b):
    """Affine a + b."""
    return to_affine(jmadd(jac(a), b))


def neg(a):
    return None if a is None else (a[0], (-a[1]) % Q)


def smul_jac(a, k: int) -> tuple:
    """k a for an affine a, as a Jacobian point: 4-bit windows, most
    significant first."""
    k %= R
    if a is None or k == 0:
        return _INF
    table = [_INF, jac(a)]
    for _ in range(14):
        table.append(jmadd(table[-1], a))
    acc = _INF
    for shift in range((k.bit_length() + 3) // 4 * 4 - 4, -1, -4):
        for _ in range(4):
            acc = jdouble(acc)
        d = (k >> shift) & 15
        if d:
            acc = jadd(acc, table[d])
    return acc


def smul(a, k: int):
    return to_affine(smul_jac(a, k))


def msm(points: list, scalars: list):
    """sum k_i P_i over affine points: Pippenger's buckets, unsigned
    windows, the width from the count."""
    pairs = [(p, k % R) for p, k in zip(points, scalars) if p is not None and k % R]
    if not pairs:
        return None
    if len(pairs) < 8:
        acc = _INF
        for p, k in pairs:
            acc = jadd(acc, smul_jac(p, k))
        return to_affine(acc)
    c = max(2, len(pairs).bit_length() - 3)
    mask = (1 << c) - 1
    acc = _INF
    for shift in range((254 + c - 1) // c * c - c, -1, -c):
        for _ in range(c):
            acc = jdouble(acc)
        buckets = [_INF] * (1 << c)
        for p, k in pairs:
            d = (k >> shift) & mask
            if d:
                buckets[d] = jmadd(buckets[d], p)
        run, total = _INF, _INF
        for d in range(mask, 0, -1):
            run = jadd(run, buckets[d])
            total = jadd(total, run)
        acc = jadd(acc, total)
    return to_affine(acc)


class FixedBase:
    """k P for one fixed affine P: a table of d 2^(8j) P for the 32
    windows of 8 bits, so a product is 32 mixed adds."""

    def __init__(self, p):
        rows, base = [], jac(p)
        for _ in range(32):
            row = [_INF, base]
            for _ in range(254):
                row.append(jadd(row[-1], base))
            rows.append(row)
            base = jdouble(row[128])
        flat = batch_to_affine([q for row in rows for q in row])
        self.table = [flat[j * 256 : (j + 1) * 256] for j in range(32)]

    def mul_jac(self, k: int) -> tuple:
        k %= R
        acc = _INF
        for j in range(32):
            d = (k >> (8 * j)) & 255
            if d:
                acc = jmadd(acc, self.table[j][d])
        return acc

    def mul_many(self, ks: list) -> list:
        return batch_to_affine([self.mul_jac(k) for k in ks])


# ---------------------------------------------------------------------------
# Encodings (ark-serialize 0.4) and hashing
# ---------------------------------------------------------------------------


def fr_bytes(x: int) -> bytes:
    return (x % R).to_bytes(32, "little")


def compress(a) -> bytes:
    """32 little-endian bytes of x; bit 7 of the last byte when y > -y,
    bit 6 alone at infinity."""
    if a is None:
        return bytes(31) + b"\x40"
    out = bytearray(a[0].to_bytes(32, "little"))
    if a[1] > Q - a[1]:
        out[31] |= 0x80
    return bytes(out)


def expand_message_xmd(msg: bytes, dst: bytes, length: int) -> bytes:
    """RFC 9380 section 5.3.1 over SHA-256."""
    ell = -(-length // 32)
    dst_prime = dst + bytes([len(dst)])
    b0 = hashlib.sha256(bytes(64) + msg + length.to_bytes(2, "big") + b"\x00" + dst_prime).digest()
    blocks = [hashlib.sha256(b0 + b"\x01" + dst_prime).digest()]
    for i in range(2, ell + 1):
        mixed = bytes(x ^ y for x, y in zip(b0, blocks[-1]))
        blocks.append(hashlib.sha256(mixed + bytes([i]) + dst_prime).digest())
    return b"".join(blocks)[:length]


def hash_to_fr(msg: bytes, dst: bytes) -> int:
    """arkworks' DefaultFieldHasher<Sha256> for one Fr element: 48 bytes,
    big-endian, reduced mod r."""
    return int.from_bytes(expand_message_xmd(msg, dst, 48), "big") % R


def _sqrt(v: int):
    root = pow(v, (Q + 1) // 4, Q)
    return root if root * root % Q == v % Q else None


def point_from_random_bytes(raw: bytes):
    """arkworks' ``from_random_bytes``: -> a point, None (infinity), or
    False where the bytes give no point."""
    flags = raw[31] & 0xC0
    x = int.from_bytes(raw[:31] + bytes([raw[31] & 0x3F]), "little")
    if x >= Q or flags == 0xC0:
        return False
    if flags == 0x40:
        return None if x == 0 else False
    y = _sqrt((x * x * x + B) % Q)
    if y is None:
        return False
    hi, lo = max(y, Q - y), min(y, Q - y)
    return (x, hi if flags == 0 else lo)


def try_and_increment(seed: bytes, num: int) -> list:
    """SHA-256(seed || u64 LE counter) until ``num`` points are found
    (``IPAPointGenerator::gen``)."""
    out, i = [], 0
    while len(out) < num:
        pt = point_from_random_bytes(hashlib.sha256(seed + i.to_bytes(8, "little")).digest())
        if pt is not False:
            out.append(pt)
        i += 1
    return out


class Transcript:
    """The reference's TranscriptHasher: append label || encoding; a
    digest hashes the state || label to Fr and, when cleared, restarts
    the state as the challenge's bytes || label."""

    def __init__(self, label: str):
        self.dst = label.encode()
        self.state = bytearray()

    def append(self, raw: bytes, label: str) -> None:
        self.state += label.encode() + raw

    def scalar(self, v: int, label: str) -> None:
        self.append(fr_bytes(v), label)

    def point(self, a, label: str) -> None:
        self.append(compress(a), label)

    def usize(self, v: int, label: str) -> None:
        self.append(v.to_bytes(8, "little"), label)

    def digest(self, label: str) -> int:
        self.state += label.encode()
        x = hash_to_fr(bytes(self.state), self.dst)
        self.state = bytearray(fr_bytes(x) + label.encode())
        return x
