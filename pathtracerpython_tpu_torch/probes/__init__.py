"""Probes that price a primitive on the card: ``mma_probe`` (P1, the
Plücker side products on the CUDA cores and on the tensor cores beside the
classic test) and ``bf16_probe`` (P2, the classic test in bf16 beside
float32). Each runs as ``python -m pathtracerpython_tpu_torch.probes.<name>``."""
