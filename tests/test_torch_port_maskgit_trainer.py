"""MaskGitTrainer and MaskGITPipeline of ct_clip_tpu_torch against the JAX
package, f32, CPU.

The tiny MaskGit and TokenCritic of tests/test_torch_port_maskgit.py
(`build_ref`: JAX weights carried across with `*_state_dict_from_jax`), JAX's
random draws derived from its keys and handed to the port.  Tolerances:
losses 1e-5 relative, every parameter and Adam moment after a step 1e-5
(absolute, against max(|p|, 1)), the lr 1e-6, the decoded volumes 1e-4 of
their largest entry.  The CPB MLP's output bias has a zero true gradient:
Adam turns its rounding noise into steps of up to lr, so its update is held
to that bound.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_port_maskgit import (B, GRID, M, N, T5D, V, ZERO_GRAD, _close, _jkey,
                                           _t, build_ref, critic_draws, loss_draws,
                                           sampler_draws)


@pytest.fixture(scope="module")
def ref():
    return build_ref()


def test_trainer_two_steps_and_checkpoint_match_jax(ref, tmp_path):
    """Two MaskGitTrainer.train_steps (the MaskGit's loss, then the critic's
    on the detached logits, each with its own AdamW) against JAX's, from
    the same weights, with the context: losses, the lr, every parameter and
    the Adam moments after each step (the second from JAX's state); the
    zero-true-gradient bias to Adam's step bound.  Then the `.pt`
    checkpoint restores equal."""
    from ct_clip_tpu.train.maskgit_trainer import MaskGitTrainer as JTrainer
    from ct_clip_tpu_torch.convert.from_jax import (critic_state_dict_from_jax,
                                                    maskgit_state_dict_from_jax)
    from ct_clip_tpu_torch.models import CTViT, MaskGit, TokenCritic
    from ct_clip_tpu_torch.config import CTViTConfig
    from ct_clip_tpu_torch.train import MaskGitTrainer

    jcfg, pcfg = ref["jcfg"], ref["pcfg"]
    ids = ref["ids"].reshape(B, *GRID)
    kw = dict(lr=1e-3, first_cycle_steps=100, warmup_steps=0, save_model_every=2)
    jt = JTrainer(ref["jm"], None, None, critic=ref["jc"],
                  results_folder=str(tmp_path / "jax"), save_model_every=10 ** 9,
                  **{k: v for k, v in kw.items() if k != "save_model_every"})
    jctx = jnp.asarray(ref["ctx"])
    jt.init(jnp.asarray(ids), GRID, jctx)
    pm, pc = MaskGit(pcfg, num_tokens=V), TokenCritic(pcfg, num_tokens=V)
    tiny_vit = CTViT(CTViTConfig(dim=16, codebook_size=8, image_size=16, patch_size=8,
                                 temporal_patch_size=2, num_frames=4, spatial_depth=1,
                                 temporal_depth=1, dim_head=8, heads=2, with_decoder=True))
    pt = MaskGitTrainer(pm, tiny_vit, pc, results_folder=str(tmp_path / "port"), **kw)

    def load_from_jax():
        s = pt.state
        s.maskgit.load_state_dict(maskgit_state_dict_from_jax(jt.state["params"], pcfg))
        s.critic.load_state_dict(critic_state_dict_from_jax(jt.state["critic_params"], pcfg))
        for opt, tree, conv in ((s.optimizer, jt.state["opt_state"], maskgit_state_dict_from_jax),
                                (s.critic_optimizer, jt.state["critic_opt_state"],
                                 critic_state_dict_from_jax)):
            adam = tree[1][0]
            mu, nu = conv(adam.mu, pcfg), conv(adam.nu, pcfg)
            names = {id(p): n for n, p in (s.maskgit if conv is maskgit_state_dict_from_jax
                                           else s.critic).named_parameters()}
            for p in opt.params:
                if int(adam.count):
                    opt.opt.state[p] = {"step": torch.tensor(float(adam.count)),
                                        "exp_avg": mu[names[id(p)]].clone(),
                                        "exp_avg_sq": nu[names[id(p)]].clone()}
            opt.count = int(adam.count)

    for step in range(2):
        load_from_jax()
        before = {k: v.clone() for k, v in pt.state.maskgit.state_dict().items()}
        rng = jax.random.fold_in(jax.random.PRNGKey(jt.seed), step)
        want = jt.train_step(jnp.asarray(ids), GRID, context=jctx)
        logits_shape = (B, N, V)
        got = pt.train_step(torch.from_numpy(ids), GRID, context=_t(ref["ctx"]), draws={
            "maskgit": loss_draws(rng, B, N),
            "critic": critic_draws(jax.random.fold_in(rng, 7), logits_shape)})
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
        assert abs(got["critic_loss"] - want["critic_loss"]) <= 1e-5 * abs(want["critic_loss"])
        assert abs(got["lr"] - want["lr"]) <= 1e-6 * want["lr"]
        bound = 2 * want["lr"]
        for model, opt, tree, conv in (
                (pt.state.maskgit, pt.state.optimizer, jt.state["opt_state"],
                 maskgit_state_dict_from_jax),
                (pt.state.critic, pt.state.critic_optimizer, jt.state["critic_opt_state"],
                 critic_state_dict_from_jax)):
            mu = conv(tree[1][0].mu, pcfg)
            for name, p in model.named_parameters():
                if p.numel() and not name.endswith(ZERO_GRAD):
                    _close(opt.opt.state[p]["exp_avg"], mu[name], 1e-4)
        for model, params, conv in (
                (pt.state.maskgit, jt.state["params"], maskgit_state_dict_from_jax),
                (pt.state.critic, jt.state["critic_params"], critic_state_dict_from_jax)):
            sd = conv(params, pcfg)
            for name, p in model.named_parameters():
                if not p.numel():
                    continue
                if name.endswith(ZERO_GRAD):
                    assert (p.detach() - before[name]).abs().max().item() <= bound, name
                    continue
                err = (p.detach() - sd[name]).abs().max().item()
                assert err <= 1e-5 * max(sd[name].abs().max().item(), 1.0), (step, name, err)
    assert pt.ckpt.latest_step == 2
    pm2, pc2 = MaskGit(pcfg, num_tokens=V), TokenCritic(pcfg, num_tokens=V)
    other = MaskGitTrainer(pm2, tiny_vit, pc2, results_folder=str(tmp_path / "restored"), **kw)
    pt.ckpt.restore(other.state)
    assert other.state.step == 2
    for a, b_ in ((pt.state.maskgit, pm2), (pt.state.critic, pc2)):
        for (k, t), t2 in zip(a.state_dict().items(), b_.state_dict().values()):
            assert torch.equal(t, t2), k
    assert other.state.optimizer.count == pt.state.optimizer.count == 2


def test_pipeline_sample_decodes_like_jax(ref):
    """MaskGITPipeline.sample through a tiny CTViT autoencoder whose (2, 4,
    4) grid is the MaskGit's (4 frames of 32 x 32): two texts' embeddings, 3
    steps with the critic and CFG, JAX's draws; the decoded volumes'
    shape, finiteness and values against JAX's pipeline from the same
    weights.  Then a primed sample (the last 2 frames of each volume, 2
    frames sampled) against JAX's."""
    import ct_clip_tpu as J
    from ct_clip_tpu.convert.torch_to_jax import (_cpb, _linear, ctvit_params_from_torch,
                                                  maskgit_transformer_from_torch)
    from ct_clip_tpu.models import CTViT as JCTViT
    from ct_clip_tpu.models.pipeline import MaskGITPipeline as JPipeline
    from ct_clip_tpu_torch.config import CTViTConfig
    from ct_clip_tpu_torch.models import CTViT, MaskGITPipeline

    vit = dict(dim=16, codebook_size=V, image_size=32, patch_size=8, temporal_patch_size=2,
               num_frames=4, spatial_depth=1, temporal_depth=1, dim_head=8, heads=2,
               with_decoder=True)
    pv = CTViT(CTViTConfig(**vit)).init_weights(torch.Generator().manual_seed(19))
    sd = pv.state_dict()
    jv_cfg = J.CTViTConfig(**vit, vq_exact_sim=True)
    params, vq = ctvit_params_from_torch(sd, jv_cfg)
    params.update(dec_spatial_rel_pos_bias=_cpb(sd, "dec_spatial_rel_pos_bias"),
                  to_pixels=_linear(sd, "to_pixels"),
                  dec_temporal_transformer=maskgit_transformer_from_torch(
                      sd, "dec_temporal_transformer", 1),
                  dec_spatial_transformer=maskgit_transformer_from_torch(
                      sd, "dec_spatial_transformer", 1))
    ctx_table = np.random.RandomState(20).randn(3, M, T5D).astype(np.float32)
    texts = ["a", "bb"]

    def embed(ts):
        return ctx_table[[len(t) for t in ts]]

    jp = JPipeline(JCTViT(jv_cfg), {"params": params, "vq": vq}, ref["jm"],
                   {"params": ref["mparams"]}, critic=ref["jc"],
                   critic_variables={"params": ref["cparams"]}, text_embed_fn=embed, steps=3)
    pp = MaskGITPipeline(pv, ref["pm"], critic=ref["pc"], text_embed_fn=lambda ts: _t(embed(ts)),
                         steps=3)
    key = _jkey(25)
    want = np.asarray(jp.sample(num_frames=4, texts=texts, rng=key))
    got = pp.sample(num_frames=4, texts=texts, draws=sampler_draws(key, 3, B, N, V))
    assert got.shape == (B, 4, 32, 32, 1) and torch.isfinite(got).all()
    _close(got, want)
    prime = want[:, -2:]
    want_p = np.asarray(jp.sample(num_frames=2, texts=texts, prime_frames=jnp.asarray(prime),
                                  rng=key))
    got_p = pp.sample(num_frames=2, texts=texts, prime_frames=_t(prime),
                      draws=sampler_draws(key, 3, B, N // 2, V))
    assert got_p.shape == (B, 2, 32, 32, 1) and torch.isfinite(got_p).all()
    _close(got_p, want_p)


def test_pipeline_make_video_chains_primed_scenes(ref):
    """make_video: each scene after the first is primed with the previous
    scene's last frames (one generator per scene, seeded by its index), so
    the chain repeats exactly, and the scenes are joined along frames."""
    from ct_clip_tpu_torch.config import CTViTConfig
    from ct_clip_tpu_torch.models import CTViT, MaskGITPipeline

    vit = CTViT(CTViTConfig(dim=16, codebook_size=V, image_size=32, patch_size=8,
                            temporal_patch_size=2, num_frames=4, spatial_depth=1,
                            temporal_depth=1, dim_head=8, heads=2, with_decoder=True)
                ).init_weights(torch.Generator().manual_seed(26))
    table = np.random.RandomState(27).randn(3, M, T5D).astype(np.float32)
    pipe = MaskGITPipeline(vit, ref["pm"], critic=ref["pc"],
                           text_embed_fn=lambda ts: _t(table[[len(t) for t in ts]]), steps=2)
    video, scenes = pipe.make_video(["a", "bb", "a"], num_frames=2, prime_lengths=2)
    assert video.shape == (1, 6, 32, 32, 1) and torch.isfinite(video).all()
    assert [s.shape[1] for s in scenes] == [2, 2, 2]
    again, _ = pipe.make_video(["a", "bb", "a"], num_frames=2, prime_lengths=2)
    assert torch.equal(video, again)
    # scene 0 is a plain sample from generator 0
    first = pipe.sample(num_frames=2, texts=["a"], generator=torch.Generator().manual_seed(0))
    assert torch.equal(scenes[0], first)
