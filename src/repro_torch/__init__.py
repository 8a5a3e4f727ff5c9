"""PyTorch/CUDA port of the REAP snapshot-serving system.

Mirrors ``repro``'s module names (``repro/core/restore.py`` ->
``repro_torch/core/restore.py``) and imports neither ``jax`` nor ``repro``.
The entry points run on the CUDA device unless the caller asks for the CPU
(``ServeConfig(device="cpu")``).
"""
