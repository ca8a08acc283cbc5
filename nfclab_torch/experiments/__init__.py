"""Counterparts of the repository's ``experiments/`` scripts on CUDA.

- ``membw_probe``: the HBM streaming copy probe (``copy_probe``).
- ``probe_serial_floor``: the conditioning chain alone, one sample a step
  (``serial_probe``).
- ``probe_pair_spec``: the same chain two samples a step with speculative
  envelope quotients (``pair_probe``).
- ``fused_v2``: the earlier design of the fused frontend, with its own
  state layout.
- ``bench_v2``: fused_v2 against the production fused frontend.

Each runs as ``python -m nfclab_torch.experiments.<name>`` on the card, or
with ``--device cpu`` through the kernels' plain PyTorch versions.
"""
