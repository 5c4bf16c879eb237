"""PyTorch/CUDA port of oryx_tpu for one NVIDIA H100.

Module paths mirror ``oryx_tpu`` so each counterpart is easy to find. The
package imports ``torch`` and never ``jax`` or ``oryx_tpu``; entry points
run on the card unless the caller passes ``device="cpu"`` (device.py).
"""
