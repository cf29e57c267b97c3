"""PyTorch/CUDA port of the UNINA-YOLO-DLA perception stack.

Serves the committed int8 engine (``artifacts/serving_artifact``) from one
RGB frame to cone ``Detections`` on an NVIDIA H100. The four kernels of the
serving path are hand-written CUDA C++ under ``csrc/``; each has a plain
PyTorch version beside its wrapper (``ops/cuda/``), used for CPU tensors.
Activations are NHWC at every public function.
"""
