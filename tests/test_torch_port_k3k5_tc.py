"""K3 bf16 (the GEGLU feed-forward forward) and K5's inference assignment on
the Hopper tensor cores (csrc/ffn_tc.cu's GEGLU and residual forms,
csrc/vq_tc.cu) emulated on the CPU and held against the JAX package's Pallas
kernels in interpret mode.

K3: the kernel keeps a = xn wa^T and g = xn wg^T in f32 accumulators, writes
act = bf16(a gelu(g)) (exact erf) and out = bf16(f32(act wo^T) + x), as the
TPU kernel rounds them (ffn.py::_kernel :97-102).  Tolerance: 2e-2 of
max|JAX|, the port's bf16 K3 tolerance.

K5: each thread of the kernel keeps a running (max, index) for its two
rows, taking its accumulator columns in increasing order with a strict >,
and the four threads of a row merge by xor shuffles (1, then 2), the lower
index winning a tie; on f32 rows a pre-pass normalises each row in the order
of `ops/vq.py::_lane_inv_norm` and rounds it to bf16.  The merge must give
torch.argmax's ids exactly, ties included; the f32-row plain version must
give `pallas_assign`'s ids where the top code is clear of the second.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

BF = torch.bfloat16
TOL = 2e-2
TILE = 128  # codes of a tile of vq_tc.cu


def k3_tc_emulated(x, scale, bias, wi, wo, eps=1e-5):
    """out (rows, dim) bf16 as ffn_tc.cu's two forms compute it after the
    bf16 LN: a and g summed in f32 from bf16 operands, act rounded once,
    act wo^T summed in f32, x added, rounded once."""
    from ct_clip_tpu_torch.ops.norms import layer_norm

    inner = wo.shape[1]
    xn = layer_norm(x, scale, bias, eps).float()
    w = wi.to(BF).float()
    a, g = xn @ w[:inner].t(), xn @ w[inner:].t()
    act = (a * (0.5 * g * (1.0 + torch.erf(g * 0.70710678118654752)))).to(BF)
    return ((act.float() @ wo.to(BF).float().t()) + x.float()).to(BF)


def k5_tc_argmax_emulated(sim: torch.Tensor, tie_rule: bool = True) -> torch.Tensor:
    """ids (rows,) as vq_tc.cu's threads find them in a (rows, codes)
    similarity matrix: thread q4 of a row visits codes 128 t + 64 half + 8 q
    + 2 q4 + u in the order (t, half, q, u) with a strict >, codes past the
    last skipped; then the xor-1 and xor-2 merges, a larger value winning
    and, with `tie_rule`, an equal one with a lower index."""
    rows, n = sim.shape
    tiles = -(-n // TILE)
    codes = torch.arange(tiles * TILE).view(tiles, 2, 8, 4, 2)
    order = codes.permute(3, 0, 1, 2, 4).reshape(4, -1)  # (q4, visit) -> code
    best = torch.full((rows, 4), -float("inf"))
    arg = torch.zeros((rows, 4), dtype=torch.long)
    for step in range(order.shape[1]):
        col = order[:, step]
        ok = col < n
        v = sim[:, col.clamp(max=n - 1)]
        take = (v > best) & ok
        best, arg = torch.where(take, v, best), torch.where(take, col.expand(rows, 4), arg)
    lanes = torch.arange(4)
    for o in (1, 2):
        ov, oi = best[:, lanes ^ o], arg[:, lanes ^ o]
        take = (ov > best) | ((ov == best) & (oi < arg)) if tie_rule else ov > best
        best, arg = torch.where(take, ov, best), torch.where(take, oi, arg)
    return arg[:, 0]


def _tied_sims(rows: int, codes: int, seed: int) -> torch.Tensor:
    """Exact similarities with many ties: small integer rows against small
    integer codes (every product and sum exact in f32), and the codes of a
    few rows' best planted again at a higher index and, for other rows,
    at a lower one."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randint(-2, 3, (rows, 16)).astype(np.float32))
    c = torch.from_numpy(rng.randint(-1, 2, (codes, 16)).astype(np.float32))
    best = (x @ c.t()).argmax(dim=-1)
    for r in range(0, rows, 7):
        c[(int(best[r]) + 1 + 37 * r) % codes] = c[best[r]]
    return x @ c.t()


@pytest.mark.parametrize("rows,codes", [(64, 8192), (96, 1000), (40, 130), (8, 64)])
def test_k5_merge_gives_torch_argmax_on_exact_ties(rows, codes):
    """The per-thread strict > and the quad merge give torch.argmax's ids
    bit for bit on exactly tied similarities, ragged code counts included;
    a merge that ignores the index on a tie does not."""
    sim = _tied_sims(rows, codes, seed=rows + codes)
    ties = (sim == sim.max(dim=-1, keepdim=True).values).sum(dim=-1)
    assert (ties > 1).any()
    want = sim.argmax(dim=-1)
    assert torch.equal(k5_tc_argmax_emulated(sim), want)
    if (ties > 1).float().mean() > 0.2:
        assert not torch.equal(k5_tc_argmax_emulated(sim, tie_rule=False), want)


@pytest.fixture(scope="module")
def pallas_interpret():
    from ct_clip_tpu.ops.pallas import _call

    _call.set_interpret(True)
    jax.clear_caches()  # plans are resolved at trace time
    yield
    _call.set_interpret(False)
    jax.clear_caches()


def test_k5_lane_norm_rows_match_pallas_assign_on_f32_rows(pallas_interpret):
    """`vq_assign_rows_lane_plain` (the card's plain version of the f32-row
    kernel: the row norm in the pre-pass's order, bf16 rows) against the JAX
    package's `pallas_assign(exact=False)` on f32 rows in interpret mode, on
    rows whose best code is clear of the second: ids equal."""
    from ct_clip_tpu.ops.norms import l2norm as jl2norm
    from ct_clip_tpu.ops.pallas.vq import _plan, pallas_assign
    from ct_clip_tpu_torch.ops.vq import vq_assign_rows_lane_plain, vq_rows_lane_sim

    rng = np.random.RandomState(19)
    n, dim, k = 512, 128, 256
    embed_n = np.array(jl2norm(jnp.asarray(rng.randn(k, dim).astype(np.float32))))
    want = rng.randint(0, k, n)
    x = (3.0 * embed_n[want] + 0.5 * rng.randn(n, dim) / np.sqrt(dim)).astype(np.float32)
    x *= rng.uniform(0.5, 4.0, (n, 1)).astype(np.float32)
    m = _plan(n, dim, k)
    assert m is not None
    ref = np.asarray(pallas_assign(jnp.asarray(x), jnp.asarray(embed_n), m, exact=False))
    xt, et = torch.from_numpy(x), torch.from_numpy(embed_n)
    sim = vq_rows_lane_sim(xt, et)
    top2 = sim.topk(2, dim=-1).values
    assert ((top2[:, 0] - top2[:, 1]) > 0.1 * top2[:, 0]).all()  # a clear margin
    got = vq_assign_rows_lane_plain(xt, et).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, want)


def test_k5_lane_norm_is_the_stats_kernels_norm():
    """The pre-pass's rows are x times `_lane_inv_norm` rounded to bf16, the
    inverse norm K15's f32 form uses: within an ulp of the full-f32 rsqrt,
    and a row of zeros stays zero (the 1e-24 floor)."""
    from ct_clip_tpu_torch.ops.vq import _lane_inv_norm

    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(64, 512).astype(np.float32))
    x[3] = 0.0
    inv = _lane_inv_norm(x)
    full = torch.rsqrt(torch.clamp_min((x.double() ** 2).sum(-1, keepdim=True), 1e-24))
    rel = ((inv.double() - full) / full).abs()
    assert rel[torch.arange(64) != 3].max() < 2 ** -22
    assert torch.equal((x * inv).to(BF)[3], torch.zeros(512, dtype=BF))


@pytest.fixture(scope="module")
def k3_case(pallas_interpret):
    """(the port's bf16 x and weights, the JAX package's bf16 K3 output
    with the residual): 1,024 rows of 128, inner 341."""
    from ct_clip_tpu.ops.pallas.ffn import _pallas_ff, _plan

    rng = np.random.RandomState(2191)
    rows, dim = 1024, 128
    inner = int(4 * (2.0 / 3.0) * dim)
    a = dict(x=rng.randn(rows, dim), scale=1 + 0.2 * rng.randn(dim), bias=0.1 * rng.randn(dim),
             wia=rng.randn(dim, inner) / np.sqrt(dim), wig=rng.randn(dim, inner) / np.sqrt(dim),
             wo=rng.randn(inner, dim) / np.sqrt(inner))
    j = {k: jnp.asarray(v.astype(np.float32)).astype(jnp.bfloat16) for k, v in a.items()}
    m = _plan((rows, dim), dim, inner, 2)
    assert m is not None
    ref = _pallas_ff(*(j[k] for k in ("x", "scale", "bias", "wia", "wig", "wo")), 1e-5, m,
                     residual=True)
    t = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(BF) for k, v in j.items()}
    port = (t["x"], t["scale"].float(), t["bias"].float(),
            torch.cat([t["wia"].t(), t["wig"].t()]).contiguous(), t["wo"].t().contiguous())
    return port, np.asarray(ref.astype(jnp.float32)).astype(np.float64)


def _rel(got, ref):
    return np.abs(got.float().numpy().astype(np.float64) - ref).max() / np.abs(ref).max()


def test_k3_tc_rounding_against_jax(k3_case):
    """The emulated forms (a and g in f32, act and out each rounded once)
    land within 2e-2 of max|JAX bf16 _pallas_ff|, as the port's plain
    version, the card's reference, does."""
    from ct_clip_tpu_torch.ops.ffn import geglu_ff_plain

    port, ref = k3_case
    got, plain = k3_tc_emulated(*port), geglu_ff_plain(*port)
    assert got.dtype == BF and got.shape == plain.shape
    errs = _rel(got, ref), _rel(plain, ref)
    assert max(errs) <= TOL, f"tensor-core form {errs[0]:.3e}, plain {errs[1]:.3e} of max|JAX|"
    # the tensor-core form keeps a and g in f32, as the TPU kernel does: it
    # lands no farther from JAX than the plain version, which rounds them
    assert errs[0] <= errs[1]
