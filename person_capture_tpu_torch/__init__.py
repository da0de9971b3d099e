"""person_capture_tpu_torch — the PyTorch/CUDA port of person_capture_tpu.

Same module paths as the JAX package, which stays the reference and is never
imported from here. Runs on a CUDA device (an NVIDIA H100, sm_90a) unless
the caller asks for the CPU.

Layering:
  core/      host geometry, scoring, bank (copied)
  models/    SCRFD, ArcFace iResNet, YOLOv8 and the CLIP ViT as
             ``nn.Module``s, the flax→torch bridge, the torch-checkpoint
             loaders and the ONNX adapters
  ops/       letterbox, NMS, 5-pt alignment warp, chip quality (torch ops)
  kernels/   HDR tone-map family, still colour match and cleanup;
             ``csrc/tonemap.cu`` is the hand-written kernel, built at first
             use by ``kernels/build.py``
  video/     host-side decode/probe/keyframe index (copied)
  pipeline/  pre-scan, main pass, saver, engine (copied) and the torch
             face and person backends
  hdr/       full-resolution HDR→SDR still export, speckle diagnostics
  tools/     checkpoint IO and conversion, the ONNX reader/writer,
             interpreter and exporter
  main.py, sweep.py, doctor.py, curator/   the entry points
"""

__version__ = "0.1.0"
