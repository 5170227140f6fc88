"""The plan of the fwht kernel (``kernels/fwht_plan.py``, the bit maps that
``csrc/fwht.cu`` computes at compile time) and its replay
(``ref.fwht_staged``): the checks of the kernel's index arithmetic that run
without a card. For every power of two d from 2 to 32,768, in fp32 and bf16:
the replay equals ``fwht_ref`` (and, at d ≤ 1,024, the JAX kernel in
interpret mode); every bit of the row is staged once; the block fits the
card; each warp's access to device memory is 512 contiguous bytes and its
access to shared memory is free of bank conflicts. The kernel itself is
held to its plan, to the replay and to ``fwht_ref`` in
``test_torch_cuda.py``.

Tolerances: 1e-5 fp32 (sums of a butterfly tree taken in another order),
5e-2 bf16 (one bf16 rounding of values of order 1), as the kernel's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ref
from repro_torch.kernels.fwht_plan import plan

DS = [2 ** k for k in range(1, 16)]
DTYPES = [torch.float32, torch.bfloat16]
TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}


def _index(layout, warp: int, lane: int, j: int) -> int:
    """Tile index of register j of (warp, lane) under ``layout``."""
    i = 0
    for bits, coord in ((layout.reg, j), (layout.lane, lane),
                        (layout.warp, warp)):
        for k, b in enumerate(bits):
            i |= ((coord >> k) & 1) << b
    return i


def _accesses(p, layout):
    """Each warp instruction's 16-byte accesses: (warp, access, lanes'
    first tile indices)."""
    vec = 1 << p.vec_log
    for warp in range(p.threads // 32):
        for h in range(p.E // vec):
            yield warp, h, [_index(layout, warp, lane, h * vec)
                            for lane in range(32)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", DS)
def test_replay_matches_plain(d, dtype):
    """Three rows (a ragged block for every narrow plan) and a 3-D input."""
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.normal(size=(3, d)).astype(np.float32)).to(dtype)
    p = plan(d, dtype)
    got = ref.fwht_staged(x, p)
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), ref.fwht_ref(x).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    x3 = x.reshape(3, 1, d).expand(3, 2, d)
    torch.testing.assert_close(ref.fwht_staged(x3, p), got[:, None].expand(3, 2, d),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [d for d in DS if d <= 1024])
def test_replay_matches_jax_kernel(d, dtype):
    rng = np.random.default_rng(d + 1)
    x = rng.normal(size=(5, d)).astype(np.float32)
    want = jops.fwht(jnp.asarray(x).astype(dtype), impl="interpret")
    tdtype = getattr(torch, dtype)
    got = ref.fwht_staged(torch.from_numpy(x).to(tdtype), plan(d, tdtype))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=TOL[tdtype], atol=TOL[tdtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", DS)
def test_plan_stages_every_bit_once_and_fits(d, dtype):
    p = plan(d, dtype)
    L = d.bit_length() - 1
    assert sorted(p.reg_stages_load + p.lane_stages + p.reg_stages_store) \
        == list(range(L))
    assert p.threads % 32 == 0 and p.threads <= 1024
    assert p.smem <= 227 * 1024
    assert p.rows_per_block * d == 1 << p.tile_log
    assert (1 << len(p.load.reg)) == p.E == (1 << len(p.store.reg))
    assert p.threads * p.E == 1 << p.tile_log
    # at most one write and one read of each fp32 value in shared memory:
    # 2x the fp32 row, 4x the bf16 row
    assert p.smem_bytes_per_row <= 4 * d * p.itemsize
    assert p.smem == (4 * d if p.wide else 0)
    if d == 16384:
        assert 16 <= p.E <= 64


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", DS)
def test_accesses_are_coalesced_and_free_of_bank_conflicts(d, dtype):
    p = plan(d, dtype)
    vec = 1 << p.vec_log
    for layout in {p.load, p.store}:
        for _, _, first in _accesses(p, layout):
            # device memory: 32 lanes × 16 bytes side by side
            assert first == [first[0] + lane * vec for lane in range(32)]
            assert first[0] % (32 * vec) == 0
    if not p.wide:
        return
    slots = sorted(p.smem_addr(i) for i in range(d))
    assert slots == list(range(d))                # a bijection onto the row
    for layout in (p.load, p.store):
        for _, _, first in _accesses(p, layout):
            for g in range(vec // 4):             # the access's float4 groups
                slot = [p.smem_addr(i + 4 * g) for i in first]
                assert all(s % 4 == 0 for s in slot)
                for quarter in range(4):          # 8 lanes a 128-bit phase
                    banks = {s // 4 % 8 for s in slot[8 * quarter:8 * quarter + 8]}
                    assert len(banks) == 8


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_plan_refuses_what_the_kernel_lacks(dtype):
    for d in (0, 1, 3, 12288, 65536):
        with pytest.raises(ValueError, match="power of two"):
            plan(d, dtype)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        plan(1024, torch.float16)
