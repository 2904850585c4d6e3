"""PyTorch + CUDA port of the HTS reproduction (the JAX package ``repro``
stays as the reference).  The scheduler lives in :mod:`repro_torch.core.hts`.
"""
