"""PyTorch/CUDA port of ``triton_client_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: every module here
mirrors the module of the same name there and is tested against it on
the same inputs. This package imports ``torch`` and numpy and nothing
of JAX, flax or the JAX package.

Entry points (``build_yolov5_pipeline``, ``CUDAChannel``, the CLI) run
on ``cuda`` unless the caller passes ``device="cpu"``; the hand-written
CUDA kernels under ``csrc/`` are built with ``nvcc`` at first use.

    python -m triton_client_tpu_torch detect2d -i synthetic:32
"""

__version__ = "0.1.0"
