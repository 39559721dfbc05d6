"""The plain reference: BN254, the IPA and its multiproof, KZG, in Python
integers and hashlib. It imports nothing of the program under test."""
