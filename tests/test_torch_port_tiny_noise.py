"""The noise rule of chip_smoke.py's phase 7 (the tiny aux CT-CLIP step,
card against CPU) on made-up steps, CPU only: `pooled_cpu_noise` and
`compare_tiny_steps(pooled=...)`.

Each gradient is held, relative to its f32 norm, to TINY_GRAD_RATIO times
the largest relative bf16-f32 distance the CPU shows for that tensor over
the init seeds, each seed's over its own f32 norm; each tensor's update-sign
flips against the f32 step to the most the CPU's bf16 step flips on that
tensor over the seeds.  The two optimizer-step faults of
`aux_planted_faults` leave the gradients as they are and fail the update
check each names, on the CPU's step standing in for the card's.
"""
import pytest
import torch

import chip_smoke as cs

LR = 1e-3


def _side(grads, start, loss=1.0):
    """A step's dict as `tiny_ctclip_side` returns it: Adam's first step
    moves each entry by lr sign(g)."""
    grads = {n: torch.tensor(g, dtype=torch.float32) for n, g in grads.items()}
    sd = {n: start[n] - LR * torch.sign(g) for n, g in grads.items()}
    return dict(loss=loss, grads=grads, sd=sd)


def _start():
    return {"a": torch.zeros(2), "b": torch.zeros(4)}


def _pooled(*seeds):
    """pooled_cpu_noise over seeds given as (bf16 grads, f32 grads)."""
    start = _start()
    return cs.pooled_cpu_noise([(_side(c, start), _side(c32, start), start)
                                for c, c32 in seeds], LR), start


SEEDS = (  # tensor a: 10% from f32 at a small gradient, 5% (0.5 absolute) at a large one
    ({"a": [1.1, 0.0], "b": [1.0, -1.0, 1.0, 1.0]}, {"a": [1.0, 0.0], "b": [1.0, -1.0, 1.0, 1.0]}),
    ({"a": [10.5, 0.0], "b": [1.0, 1.0, 1.0, 1.0]}, {"a": [10.0, 0.0], "b": [1.0, -1.0, 1.0, 1.0]}),
)


def test_pooled_noise_is_relative_per_seed():
    """Tensor a's noise is the larger of its seeds' relative distances (10%),
    not the largest absolute distance (0.5) over the first seed's norm;
    b's sign flips pooled per tensor (one, at the second seed)."""
    noise, _ = _pooled(*SEEDS)
    assert noise["grad"]["a"] == pytest.approx(0.1, rel=1e-5)
    assert noise["flips"] == {"b": 1}
    assert noise["seeds"] == 2


@pytest.mark.parametrize("card_a, outside", [
    ([1.11, 0.0], []),  # 11% of the f32 norm: 1.1x the noise
    ([1.2, 0.0], ["gradients"]),  # 20%: 2x, though within the 0.5 absolute noise
])
def test_gradients_against_the_relative_noise(card_a, outside):
    noise, start = _pooled(*SEEDS)
    c, c32 = _side(SEEDS[0][0], start), _side(SEEDS[0][1], start)
    g = _side({"a": card_a, "b": SEEDS[0][1]["b"]}, start)
    res, fail = cs.compare_tiny_steps(c, c32, g, start, LR, pooled=noise, vq_prefix=None)
    assert fail == outside
    assert res["grad_worst"] == "a"
    assert res["grad_ratio"] == pytest.approx((card_a[0] - 1.0) / 0.1, rel=1e-4)


@pytest.mark.parametrize("card_b, over", [
    ([1.0, 1.0, 1.0, 1.0], {}),  # one flip on b, as the CPU's bf16 step at the second seed
    ([-1.0, 1.0, 1.0, 1.0], {"b": [2, 1]}),  # two flips on b
])
def test_update_signs_per_tensor(card_b, over):
    """A tensor's update-sign flips against the f32 step beyond the most
    the CPU's bf16 step flips on that tensor over the seeds fail, whatever
    the other tensors' room."""
    noise, start = _pooled(*SEEDS)
    c, c32 = _side(SEEDS[0][0], start), _side(SEEDS[0][1], start)
    g = _side({"a": SEEDS[0][1]["a"], "b": card_b}, start)
    res, fail = cs.compare_tiny_steps(c, c32, g, start, LR, pooled=noise, vq_prefix=None,
                                      grad_ratio=float("inf"))
    assert res["update_sign_flips_over"] == over
    assert ("update signs" in fail) is bool(over)
    a_only = _side({"a": [-1.0, 0.0], "b": SEEDS[0][1]["b"]}, start)  # a's large entry flips
    res, fail = cs.compare_tiny_steps(c, c32, a_only, start, LR, pooled=noise, vq_prefix=None,
                                      grad_ratio=float("inf"))
    assert res["update_sign_flips_over"] == {"a": [1, 0]} and "update signs" in fail


@pytest.fixture(scope="module")
def aux_step_on_cpu():
    """Phase 7's tiny aux step at its init seed, the CPU's bf16 side
    standing in for the card, with the CPU noise of that seed alone (phase 7
    pools five more; the pooling has its own tests above).  Two threads:
    the suite's other workers share the cores."""
    from ct_clip_tpu_torch.config import TrainConfig

    cfg, tcfg, cpu = cs.tiny_aux_config(), TrainConfig(lr=LR), torch.device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        side, start = cs.tiny_sides(cfg, tcfg)
        c, c32 = side(cpu, torch.bfloat16), side(cpu, torch.float32)
        yield side, start, c, c32, cs.pooled_cpu_noise([(c, c32, start)], LR)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("name", [n for n, f in cs.aux_planted_faults().items() if len(f) == 4])
def test_update_faults_fail_only_their_check(aux_step_on_cpu, name):
    """The optimizer-step faults of phase 7 leave every gradient as it is
    and fail the update check each names, and that one alone; the step
    without them passes."""
    side, start, c, c32, noise = aux_step_on_cpu
    held = dict(pooled=noise)
    _, fail = cs.compare_tiny_steps(c, c32, c, start, LR, **held)
    assert fail == []
    module, attr, broken, must = cs.aux_planted_faults()[name]
    with cs.replaced(module, attr, broken):
        g = side(torch.device("cpu"), torch.bfloat16)
    assert all(torch.equal(g["grads"][n], c["grads"][n]) for n in c["grads"])
    _, fail = cs.compare_tiny_steps(c, c32, g, start, LR, **held)
    assert fail == [must]


def test_card_vs_cpu_holds_a_fault_to_its_named_check():
    """A planted fault that names a check must fail that one: failing
    another does not do."""
    import types

    knob = types.SimpleNamespace(a=[1.0, 0.0], b=[1.0, -1.0, 1.0, 1.0])
    start = _start()

    def side(device, dtype):
        out = _side({"a": knob.a, "b": knob.b}, start)
        if dtype == torch.float32:
            out = _side(SEEDS[0][1], start)
        return dict(out, metrics={}, codes=None)
    def card(faults):
        return cs.card_vs_cpu(torch.device("cpu"), side, start, LR, faults, "made up",
                              noise_sides=lambda: [(_side(c, start), _side(c32, start), start)
                                                   for c, c32 in SEEDS],
                              vq_prefix=None)
    gradient_fault = (knob, "a", [2.0, 0.0])
    res, _ = card({"a off": gradient_fault, "a off, gradients": (*gradient_fault, "gradients")})
    assert res["faults"]["a off"]["outside"] == ["gradients"]
    with pytest.raises(AssertionError, match="passes the limits of update signs"):
        card({"a off, update signs": (*gradient_fault, "update signs")})
