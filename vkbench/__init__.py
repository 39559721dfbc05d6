"""The benchmark of verkle_kzg_tpu_torch: ``run.py`` runs one cell."""
