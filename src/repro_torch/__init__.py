"""repro_torch — the PyTorch/CUDA port of the BMO-NN index (NVIDIA Hopper).

It mirrors the layout of the JAX package ``repro`` module by module, so each
function's counterpart is found under the same path. The port imports
``torch`` and ``numpy`` only; the JAX package stays the reference that the
``tests/test_torch_*.py`` files hold the port against.

Ported so far — the rotated/dense k-NN query path:

    from repro_torch.api import Index
    from repro_torch.configs.bmo_nn import DENSE
    idx = Index.build(corpus, DENSE.bmo)          # on "cuda" by default
    res = idx.query(queries)                      # KNNResult (numpy)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without ``device=`` they raise. On the card the two
hot kernels (``fused_epoch_pull``, ``fwht``) are hand-written CUDA C++ in
``csrc/``, built with ``nvcc`` at first use (``kernels/_build.py``).
"""
