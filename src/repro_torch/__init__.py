"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

Layout mirrors ``repro`` module for module. The package imports ``torch``
and numpy only; its hand-written CUDA kernels live under
``kernels/csrc`` and are built with ``nvcc`` at first use.

Entry points (``serve.Engine``, ``models.Model.init``,
``launch.mesh.make_mesh``) run on ``device="cuda"`` unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.
"""
