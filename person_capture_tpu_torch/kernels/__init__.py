"""Device kernels: the HDR tone-map family (plain torch plus the hand-written
CUDA tone-map kernel in ``csrc/``) and the still colour match and cleanup
(plain torch)."""
