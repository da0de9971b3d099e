"""In-repo training for the synthetic-face model weights.

The environment has no pretrained SCRFD checkpoint and no network egress
(the reference downloads `scrfd_*_bnkps.onnx` at runtime,
person_capture/face_embedder.py:55-65); these trainers produce real weights
for the clean TPU-native architectures from procedurally generated scenes so
the full pipeline (detect → align → embed → match) runs end-to-end without
oracle backends. When a real insightface checkpoint is available,
tools/convert_weights.py remains the loading path.
"""
