"""Torch model families: SCRFD face detector, ArcFace iResNet embedder and
YOLOv8 detector (``nn.Module``s, NCHW), with the bridge that loads the JAX
package's flax checkpoints into them."""
