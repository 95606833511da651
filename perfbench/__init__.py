"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on NVIDIA H100s.

``BENCHMARK.json`` at the repository's root names the cells; ``run.py``
runs one cell once (``python3 -m perfbench.run --help``). Everything a
cell needs lives here and is found by name: ``configs/``, ``traffic/``,
``drivers/``, ``metrics/``, the plain ``reference/`` that decides
``correct``, and ``work.py``'s peaks and bounds. Nothing here imports JAX
or the JAX package, and the reference imports nothing of the program.
"""
