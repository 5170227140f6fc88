"""repro_torch — the PyTorch/CUDA port of the BMO-NN index (NVIDIA Hopper).

It mirrors the layout of the JAX package ``repro`` module by module, so each
function's counterpart is found under the same path. The port imports
``torch`` and ``numpy`` only; the JAX package stays the reference that the
``tests/test_torch_*.py`` files hold the port against.

Ported so far — the dense and rotated k-NN paths (the fused and per-round
drivers, the paper's Algorithm 2, the exact oracle) and the dense LM's
cache-free forward with its loss:

    from repro_torch.api import Index
    from repro_torch.configs.bmo_nn import DENSE
    idx = Index.build(corpus, DENSE.bmo)          # on "cuda" by default
    res = idx.query(queries)                      # KNNResult (numpy)

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.train.loss import lm_loss
    model = build_model(get_arch("qwen2.5-14b").config, param_dtype=torch.bfloat16)
    loss, metrics = lm_loss(model, {"tokens": tokens, "labels": labels})

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without ``device=`` they raise. On the card six kernels
(``fused_epoch_pull``, ``fwht``, ``block_pull_multi``, ``block_pull``,
``pairwise_dist``, ``flash_attention``) are hand-written CUDA C++ in
``csrc/``, built with ``nvcc`` at first use (``kernels/_build.py``).
"""
