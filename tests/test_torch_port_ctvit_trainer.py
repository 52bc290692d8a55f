"""The CTViT autoencoder's trainer steps in ct_clip_tpu_torch against the JAX
package's CTViTTrainer, f32, CPU.

The cases share tests/test_torch_port_ctvit_ae.py's geometry, weights and
tolerances (its docstring): a (t, h, w) = (3, 2, 2) token grid, whose
temporal stages run sequence-major (K2 seq, K10 seq), JAX eager.  They live
in a file of their own so that each file's eager JAX run stays short.
"""
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_ctvit_ae import (LR, ZERO_GRAD, _close, _port, _trainer, _video,
                                      build_ref)


@pytest.fixture(scope="module", autouse=True)
def _eager_jax():
    with jax.disable_jit():
        yield


@pytest.fixture(scope="module")
def ref():
    return build_ref()


def _jax_trainer(ref, use_discr, tmp, **kw):
    """The JAX CTViTTrainer on the fixture's weights, its steps built."""
    from ct_clip_tpu.train.ctvit_trainer import CTViTTrainer as JTrainer

    t = JTrainer(ref["jmodel"], lr=LR, use_discr=use_discr, ema_update_every=1,
                 results_folder=str(tmp), save_model_every=10 ** 9,
                 save_results_every=10 ** 9, **kw)
    params = jax.tree_util.tree_map(jnp.asarray, ref["params"])
    t.state = {"step": 0, "params": params, "vq": jax.tree_util.tree_map(jnp.asarray, ref["vq"]),
               "ema_params": params, "opt_state": t.tx.init(params)}
    if use_discr:
        dp = jax.tree_util.tree_map(jnp.asarray, ref["discr"])
        t.state.update(discr_params=dp, discr_opt_state=t.discr_tx.init(dp))
    t._build_steps()
    return t


def _sync_from_jax(trainer, js, ref):
    """The port's trainer state := the JAX trainer's: parameters, VQ
    buffers, EMA, Adam moments, and the discriminator's."""
    from ct_clip_tpu_torch.convert import (ctvit_state_dict_from_jax,
                                           discriminator_state_dict_from_jax)

    s = trainer.state
    conv = lambda t: ctvit_state_dict_from_jax({"params": t, "vq": js["vq"]},  # noqa: E731
                                               ref["pcfg"])
    s.model.load_state_dict(conv(js["params"]))
    s.ema_model.load_state_dict(conv(js["ema_params"]))
    pairs = [(s.model, s.optimizer, js["opt_state"], conv)]
    if s.discr is not None:
        s.discr.load_state_dict(discriminator_state_dict_from_jax(js["discr_params"]))
        pairs.append((s.discr, s.discr_optimizer, js["discr_opt_state"],
                      discriminator_state_dict_from_jax))
    for module, opt, jopt, to_sd in pairs:
        adam = jopt[1][0]
        mu, nu = to_sd(adam.mu), to_sd(adam.nu)
        for name, p in module.named_parameters():
            st = opt.opt.state[p]
            st["exp_avg"].copy_(mu[name])
            st["exp_avg_sq"].copy_(nu[name])


def _updates_close(module, start, want, small):
    for name, p in module.named_parameters():
        if not p.numel():
            continue
        delta = (p.detach() - start[name]).abs()
        if name.endswith(ZERO_GRAD):
            assert delta.max().item() <= LR * (1 + 1e-6), name
            continue
        diff = ((p.detach() - start[name]) - (want[name] - start[name])).abs()
        assert diff[~small[name]].max().item() <= 1e-5, name
        if small[name].any():
            assert diff[small[name]].max().item() <= 2 * LR * (1 + 1e-6), name


def _record_grads(opt, log):
    """Wrap `opt.step` to keep each step's gradients (before the clip)."""
    step = opt.step

    def recording():
        log.append([None if p.grad is None else p.grad.clone() for p in opt.params])
        return step()
    opt.step = recording


@pytest.mark.parametrize("use_discr", [False, True], ids=["recon", "discr"])
def test_two_trainer_steps_match_jax(ref, tmp_path, use_discr):
    """Two `train_step`s of the port's CTViTTrainer against the JAX
    trainer's (`_gen_step`, and with the discriminator one `_discr_step`
    after it: generator_steps=1 keeps the eager JAX side short), each from
    the same state (the port's is set to JAX's after the first): the losses,
    every parameter's update (the discriminator's too), the VQ state and the
    EMA (ema_update_every=1).  Entries whose gradient was below 1e-3 of its
    tensor's largest are held to the noise bound (module docstring)."""
    from ct_clip_tpu_torch.convert import (ctvit_state_dict_from_jax,
                                           discriminator_state_dict_from_jax)

    jt = _jax_trainer(ref, use_discr, tmp_path / "jax", generator_steps=1)
    trainer = _trainer(_port(ref), ref, use_discr, tmp_path / "port", generator_steps=1)
    s, grads = trainer.state, []
    _record_grads(s.optimizer, grads)
    for seed in (0, 1):
        if seed == 1:
            _sync_from_jax(trainer, jt.state, ref)
        video = _video(seed)
        start = {k: t.clone() for k, t in s.model.state_dict().items()}
        dstart = {k: t.clone() for k, t in s.discr.state_dict().items()} if use_discr else {}
        grads.clear()
        jlogs = jt.train_step(jnp.asarray(video))
        logs = trainer.train_step(torch.from_numpy(video))
        assert len(grads) == 1
        small = {n: torch.stack([(g[i].abs() < 1e-3 * g[i].abs().max()) for g in grads]).any(0)
                 for i, (n, p) in enumerate(s.model.named_parameters()) if p.numel()}
        assert logs.keys() == jlogs.keys()
        for key, want in jlogs.items():
            assert abs(logs[key] - want) <= 1e-5 * abs(want), key
        js = jt.state
        want = ctvit_state_dict_from_jax({"params": js["params"], "vq": js["vq"]}, ref["pcfg"])
        _updates_close(s.model, start, want, small)
        for key in ("embed", "cluster_size"):
            name = f"vq._codebook.{key}"
            _close(s.model.state_dict()[name], want[name].numpy(), 1e-5)
        ema = ctvit_state_dict_from_jax({"params": js["ema_params"], "vq": js["vq"]},
                                        ref["pcfg"])
        for name, p in s.ema_model.named_parameters():
            if p.numel():
                assert (p - ema[name]).abs().max().item() <= 1e-6, name
        if use_discr:
            dwant = discriminator_state_dict_from_jax(js["discr_params"])
            dsmall = {n: torch.zeros_like(t, dtype=torch.bool) for n, t in dwant.items()}
            _updates_close(s.discr, dstart, dwant, dsmall)
    assert s.step == jt.state["step"] == 2
    assert s.optimizer.count == 2

