"""The CTViT autoencoder of ct_clip_tpu_torch against the JAX package, f32, CPU.

A tiny non-cubic geometry (image 16, patch 8, temporal patch 2, 6 frames:
a (t, h, w) = (3, 2, 2) token grid) sends the temporal stages of the encoder
and the decoder down the sequence-major path (K2 seq, K10 seq), as
GenerateCT's 20 x 8 x 8 grid does at full width.  Weights are initialised once
in JAX (vectors moved off their init values) and carried across with
`ctvit_state_dict_from_jax`; inputs come from a numpy seed.  The codebook
holds the batch's own encoder tokens, so every VQ id is a clear top-1 on both
sides (f32 exact assignment).  The port runs its plain versions; JAX, off the
TPU, its XLA twins.

The last test is CT-CLIP on the same kind of grid (the full-width analogue
is 160 frames, (16, 24, 24)): its loss and every gradient against JAX's,
as tests/test_torch_port_train.py holds the cubic grid (BERT's key bias has
a zero true gradient too).  The trainer's steps against the JAX trainer's
are in tests/test_torch_port_ctvit_trainer.py.

Tolerances, relative to the largest entry of the reference tensor: encode,
decode, the reconstruction and the commitment loss 1e-4; the generator loss
1e-5 and its gradients 1e-4 (f32 sums in other orders through two
transformer stacks); the trainer's losses 1e-5, every parameter's update and
the VQ state 1e-5 absolute.  The CPB MLPs' output biases add one constant to
every score of a head, so their true gradient is zero: both sides hold
rounding noise there (held to 1e-6 of the largest gradient), which Adam turns
into steps of up to lr, so their updates are held to that bound, as are the
entries whose gradient is below 1e-3 of its tensor's largest.  The second
trainer step starts both sides from JAX's state, Adam moments included.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

DIM, HEADS, DIM_HEAD, CODES = 16, 2, 8, 32
IMAGE, PATCH, FRAMES, TPATCH = 16, 8, 6, 2
B, LR = 2, 1e-3
ZERO_GRAD = ("rel_pos_bias.net.2.bias",)


def _vit(**kw):
    return dict(dim=DIM, codebook_size=CODES, image_size=IMAGE, patch_size=PATCH,
                temporal_patch_size=TPATCH, num_frames=FRAMES, spatial_depth=1,
                temporal_depth=1, dim_head=DIM_HEAD, heads=HEADS, with_decoder=True, **kw)


def _video(seed, b=B, frames=FRAMES):
    rng = np.random.RandomState(seed)
    return rng.uniform(-1, 1, (b, frames, IMAGE, IMAGE, 1)).astype(np.float32)


def _close(got, ref, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got.astype(np.float64) - ref).max()
    assert err <= rtol * np.abs(ref).max() + 1e-12, f"max abs err {err:.3e}"


def _jax_params(sd, cfg):
    """The port's CTViT state dict -> JAX params, through the JAX package's
    own converter (the encoder) and its helpers (the decoder mirror)."""
    from ct_clip_tpu.convert.torch_to_jax import (_cpb, _linear, ctvit_params_from_torch,
                                                  maskgit_transformer_from_torch)

    params, vq = ctvit_params_from_torch(sd, cfg)
    params.update(dec_spatial_rel_pos_bias=_cpb(sd, "dec_spatial_rel_pos_bias"),
                  to_pixels=_linear(sd, "to_pixels"),
                  **{name: maskgit_transformer_from_torch(sd, name, depth) for name, depth in (
                      ("dec_temporal_transformer", cfg.temporal_depth),
                      ("dec_spatial_transformer", cfg.spatial_depth))})
    return params, vq


@pytest.fixture(scope="module", autouse=True)
def _eager_jax():
    with jax.disable_jit():
        yield


@pytest.fixture(scope="module")
def ref():
    return build_ref()


def build_ref():
    """Seeded port weights (vectors moved off their init values) carried to
    JAX, a codebook that holds the batch's own tokens, and the
    discriminator's weights.  JAX runs eagerly in these tests: a jit compile
    of the autoencoder's value_and_grad takes minutes on the CPU, while its
    per-op compiles are shared by every test of a file."""
    import ct_clip_tpu as J
    from ct_clip_tpu.models import CTViT as JCTViT
    from ct_clip_tpu_torch.config import CTViTConfig
    from ct_clip_tpu_torch.models import CTViT
    from ct_clip_tpu_torch.train import Discriminator3D

    jcfg, pcfg = J.CTViTConfig(**_vit(vq_exact_sim=True)), CTViTConfig(**_vit())
    g = torch.Generator().manual_seed(0)
    model = CTViT(pcfg).init_weights(g)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() <= 1:
                p.add_(0.2 * torch.randn(p.shape, generator=g))
        # the codebook: the batch's own tokens first, so each id is a clear top-1
        tokens = model.encode(model.embed_patches(torch.from_numpy(_video(0))))
        embed = model.vq._codebook.embed
        embed[: B * 12] = tokens.reshape(-1, DIM)
        embed.copy_(embed / embed.norm(dim=-1, keepdim=True))
    params, vq = _jax_params(model.state_dict(), jcfg)
    discr = Discriminator3D()
    for name, t in discr.named_parameters():
        with torch.no_grad():
            t.copy_(torch.randn(t.shape, generator=g) * (0.1 if t.dim() == 1 else
                                                          t[0].numel() ** -0.5))
    dparams = {name: {"kernel": getattr(discr, name).weight.detach().numpy().transpose(
        2, 3, 4, 1, 0), "bias": getattr(discr, name).bias.detach().numpy()}
        for name in [f"conv_{i}" for i in range(4)] + ["to_logit"]}
    return dict(jmodel=JCTViT(jcfg, dtype=jnp.float32), jcfg=jcfg, pcfg=pcfg,
                params=params, vq=vq, discr=dparams, start=model.state_dict())


def _port(ref):
    from ct_clip_tpu_torch.convert import ctvit_state_dict_from_jax
    from ct_clip_tpu_torch.models import CTViT

    model = CTViT(ref["pcfg"])
    model.load_state_dict(ctvit_state_dict_from_jax(
        {"params": ref["params"], "vq": ref["vq"]}, ref["pcfg"]), strict=True)
    return model


def _port_discr(params):
    from ct_clip_tpu_torch.convert import discriminator_state_dict_from_jax
    from ct_clip_tpu_torch.train import Discriminator3D

    d = Discriminator3D()
    d.load_state_dict(discriminator_state_dict_from_jax(params), strict=True)
    return d


def _jax_gen_loss(jmodel):
    """The JAX trainer's gen_loss_fn (ct_clip_tpu/train/ctvit_trainer.py:101-111)."""
    from ct_clip_tpu.train.ctvit_trainer import Discriminator3D, hinge_gen_loss

    def loss_fn(params, vq, video, discr_params):
        (recon, _, commit), new_vars = jmodel.apply(
            {"params": params, "vq": vq}, video, train=True, return_recons=True,
            mutable=["vq"])
        recon_loss = jnp.mean((recon.astype(jnp.float32) - video.astype(jnp.float32)) ** 2)
        fake = Discriminator3D().apply({"params": discr_params}, recon)
        return recon_loss + commit + 0.1 * hinge_gen_loss(fake), new_vars["vq"]
    return loss_fn


def test_encode_decode_and_reconstruction_match_jax(ref):
    """Sequence-major encode, decode, and the inference `return_recons`
    output: reconstruction, ids and commitment loss."""
    jm, v = ref["jmodel"], {"params": ref["params"], "vq": ref["vq"]}
    video = _video(0)
    jtok, jdec = jm.apply(v, jnp.asarray(video), method=lambda m, x: (
        lambda t: (t, m.decode(t)))(m.encode(m.embed_patches(x))))
    jrec, jids, jcommit = jm.apply(v, jnp.asarray(video), return_recons=True)
    model = _port(ref)
    for key, t in model.state_dict().items():  # the round trip through JAX is exact
        assert torch.equal(t, ref["start"][key]), key
    with torch.no_grad():
        tok = model.encode(model.embed_patches(torch.from_numpy(video)))
        dec = model.decode(torch.from_numpy(np.array(jtok)))
        rec, ids, commit = model(torch.from_numpy(video), return_recons=True)
    assert tok.shape == (B, 3, 2, 2, DIM)
    _close(tok, jtok, 1e-4)
    _close(dec, jdec, 1e-4)
    _close(rec, jrec, 1e-4)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert abs(commit.item() - float(jcommit)) <= 1e-4 * abs(float(jcommit))
    # decode_from_codebook_indices: the codes of the ids, decoded
    with torch.no_grad():
        again = model.decode_from_codebook_indices(ids, (3, 2, 2))
    _close(again, rec, 1e-5)  # rec decoded x + (q - x), not q itself


def test_generator_loss_and_gradients_match_jax(ref, tmp_path):
    """The generator loss with the discriminator term, its gradients and
    the VQ's EMA state against jax.value_and_grad of the JAX trainer's
    gen_loss_fn."""
    from ct_clip_tpu_torch.convert import ctvit_state_dict_from_jax

    video = _video(0)
    (jloss, new_vq), grads = jax.value_and_grad(_jax_gen_loss(ref["jmodel"]), has_aux=True)(
        ref["params"], ref["vq"], jnp.asarray(video), ref["discr"])
    model = _port(ref)
    trainer = _trainer(model, ref, True, tmp_path)
    loss, _, _ = trainer.generator_loss(torch.from_numpy(video))
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    loss.backward()
    want = ctvit_state_dict_from_jax({"params": grads, "vq": new_vq}, ref["pcfg"])
    params = [(n, p) for n, p in model.named_parameters() if p.numel()]
    top = max(want[n].abs().max().item() for n, _ in params)
    for name, p in params:
        if name.endswith(ZERO_GRAD):
            assert p.grad.abs().max().item() <= 1e-6 * top
            assert want[name].abs().max().item() <= 1e-6 * top
            continue
        _close(p.grad, want[name].numpy(), 1e-4)
    assert all(p.grad is None for p in trainer.state.discr.parameters())
    for key in ("embed", "cluster_size"):
        _close(model.state_dict()[f"vq._codebook.{key}"], want[f"vq._codebook.{key}"], 1e-5)


def _trainer(model, ref, use_discr, tmp, **kw):
    from ct_clip_tpu_torch.train import CTViTTrainer

    t = CTViTTrainer(model, lr=LR, use_discr=use_discr, ema_update_every=1,
                     results_folder=str(tmp), **kw)
    if use_discr:
        t.state.discr.load_state_dict(_port_discr(ref["discr"]).state_dict())
    return t


def test_trainer_generator_steps_ema_dumps_and_checkpoint_round_trip(ref, tmp_path):
    """The port's trainer alone: `generator_steps` generator updates per
    discriminator update, the EMA every `ema_update_every` steps, the
    reconstruction dumps and a save -> restore round trip of the whole
    state (model, EMA, optimizers, discriminator), after which one more step
    equals the original's."""
    from ct_clip_tpu_torch.data import read_volume
    from ct_clip_tpu_torch.train import CTViTTrainer

    def build(folder):
        return CTViTTrainer(_port(ref), lr=LR, use_discr=True, ema_update_every=2,
                            save_model_every=2, save_results_every=1,
                            results_folder=str(tmp_path / folder))

    trainer = build("a")
    s, video = trainer.state, torch.from_numpy(_video(2))
    ema0 = [p.clone() for p in s.ema_model.parameters()]
    trainer.train(iter([video] * 5), num_steps=3)
    assert s.step == 3 and s.optimizer.count == 9 and s.discr_optimizer.count == 3
    assert all(torch.equal(a, b) for a, b in zip(ema0, s.ema_model.parameters())) is False
    dumps = sorted(p.name for p in (tmp_path / "a").glob("recon_step*.nii.gz"))
    assert dumps == [f"recon_step{i}.nii.gz" for i in (1, 2, 3)]
    assert read_volume(tmp_path / "a" / dumps[0])[0].shape == (IMAGE, IMAGE, FRAMES)
    assert trainer.ckpt.steps() == [2]
    other = build("b")
    trainer.ckpt.restore(other.state, 2)
    assert other.state.step == 2
    trainer.ckpt.save(3, s)
    trainer.ckpt.restore(other.state, 3)
    for a, b in ((s.model, other.state.model), (s.ema_model, other.state.ema_model),
                 (s.discr, other.state.discr)):
        for key, t in a.state_dict().items():
            assert torch.equal(t, b.state_dict()[key]), key
    la, lb = trainer.train_step(video), other.train_step(video)
    assert la == lb


@pytest.mark.parametrize("frames,size", [(6, 16), (5, 9)], ids=["even", "odd"])
def test_discriminator_forward_and_backward_match_jax(ref, frames, size):
    """Discriminator3D's 'SAME' padding at even and odd extents: logits and
    the gradients into the input and every weight within 1e-5 relative."""
    from ct_clip_tpu.train.ctvit_trainer import Discriminator3D as JDiscr
    from ct_clip_tpu_torch.convert import discriminator_state_dict_from_jax

    rng = np.random.RandomState(frames)
    video = rng.uniform(-1, 1, (2, frames, size, size + 2, 1)).astype(np.float32)
    jf = lambda p, v: JDiscr().apply({"params": p}, v)  # noqa: E731
    out, jvjp = jax.vjp(jf, ref["discr"], jnp.asarray(video))
    dout = rng.randn(*out.shape).astype(np.float32)
    jgp, jgv = jvjp(jnp.asarray(dout))
    d = _port_discr(ref["discr"])
    x = torch.from_numpy(video).requires_grad_()
    got = d(x)
    _close(got, out, 1e-5)
    got.backward(torch.from_numpy(dout))
    _close(x.grad, jgv, 1e-5)
    want = discriminator_state_dict_from_jax(jgp)
    for name, p in d.named_parameters():
        _close(p.grad, want[name].numpy(), 1e-5)


def _write_corpus(root, n=2):
    """n NIfTI volumes of 110 slices (inside VideoDataset's 100-600), one
    with JSON metadata that rescales and flips (PNMS)."""
    import json

    from ct_clip_tpu_torch.data import write_volume

    rng = np.random.RandomState(5)
    for i in range(n):
        vol = rng.randint(-1200, 1500, (20, 24, 110)).astype(np.int16)
        write_volume(root / f"vol_{i}.nii.gz", vol, (0.8, 0.8, 1.5))
    (root / "vol_0.json").write_text(json.dumps(
        {"RescaleSlope": 1.5, "RescaleIntercept": -512, "Manufacturer": "PNMS"}))
    (root / "short.nii.gz").write_bytes(b"not a volume")


def test_generatect_datasets_match_jax(tmp_path):
    """VideoTextDataset, its superres pair and VideoDataset read the same
    NIfTIs to the same arrays (numpy on both sides: exact)."""
    from ct_clip_tpu.data import generatect as J
    from ct_clip_tpu_torch.data import generatect as P

    _write_corpus(tmp_path)
    for name, kw in (("VideoTextDataset", dict(num_frames=7, image_size=12)),
                     ("VideoTextDatasetSuperres", dict(num_frames=5, low_size=8,
                                                       high_size=20)),
                     ("VideoDataset", dict(num_frames=6, image_size=16))):
        jd, pd = getattr(J, name)(str(tmp_path), **kw), getattr(P, name)(str(tmp_path), **kw)
        assert len(pd) == len(jd) == 2
        for i in range(2):
            a, b = pd[i], jd[i]
            pairs = list(zip(a, b)) if isinstance(a, tuple) else [(a, b)]
            for x, y in pairs:
                xv, yv = (getattr(x, "video", x), getattr(y, "video", y))
                np.testing.assert_array_equal(xv, yv)
    np.testing.assert_array_equal(
        P.resize_video(np.arange(60.0).reshape(3, 4, 5), (7, 2, 9)),
        J.resize_video(np.arange(60.0).reshape(3, 4, 5), (7, 2, 9)))


def test_group_by_frame_count_matches_jax():
    """CustomBatchSampler's bucketing: the same index batches."""
    from ct_clip_tpu.train.ctvit_trainer import group_by_frame_count as jgroup
    from ct_clip_tpu_torch.train import group_by_frame_count

    frames = np.random.RandomState(8).choice([100, 201, 300], 23)
    want = list(jgroup(frames, int, 4))
    assert list(group_by_frame_count(frames, int, 4)) == want
    assert sorted(i for b in want for i in b) == list(range(23))


def test_cli_reconstruct_on_cpu_matches_jax_reconstruct_dataset(ref, tmp_path, monkeypatch):
    """`cli reconstruct --device cpu` with the fixture's weights as a .pt on
    a 2-volume corpus against the JAX package's `reconstruct_dataset`: the
    same files, NIfTI arrays within 1e-4 relative."""
    from ct_clip_tpu.data.generatect import VideoDataset as JVideo
    from ct_clip_tpu.data.nifti import read_volume as jread
    from ct_clip_tpu.train.ctvit_trainer import reconstruct_dataset as jrecon
    from ct_clip_tpu_torch import cli, config
    from ct_clip_tpu_torch.data import read_volume

    data = tmp_path / "data"
    data.mkdir()
    _write_corpus(data)
    torch.save(_port(ref).state_dict(), tmp_path / "ctvit.pt")
    jfiles = jrecon(ref["jmodel"], {"params": ref["params"], "vq": ref["vq"]},
                    JVideo(str(data), num_frames=FRAMES, image_size=IMAGE),
                    str(tmp_path / "jax"))
    monkeypatch.setattr(config, "CTViTConfig", lambda with_decoder: ref["pcfg"])
    files = cli.main(["--device", "cpu", "--no-bf16", "reconstruct", "--data", str(data),
                      "--ckpt", str(tmp_path / "ctvit.pt"), "--results",
                      str(tmp_path / "port")])
    assert [f.split("/")[-1] for f in files] == [f.split("/")[-1] for f in jfiles] \
        == ["recon_00000.nii.gz", "recon_00001.nii.gz"]
    for f, jf in zip(files, jfiles):
        got, want = read_volume(f)[0], jread(jf)[0]
        assert got.shape == (IMAGE, IMAGE, FRAMES)
        _close(got, want, 1e-4)


def test_noncubic_ctclip_loss_and_gradients_match_jax():
    """CT-CLIP with a (3, 2, 2) token grid (t != h): the contrastive loss in
    training mode, every parameter's gradient and the VQ's EMA state against
    jax.value_and_grad of the JAX CTCLIP."""
    import ct_clip_tpu as J
    from ct_clip_tpu.convert.torch_to_jax import ctclip_params_from_torch
    from ct_clip_tpu.models import CTCLIP as JCTCLIP
    from ct_clip_tpu_torch import config as P
    from ct_clip_tpu_torch.convert import state_dict_from_jax
    from ct_clip_tpu_torch.models import CTCLIP

    vit = dict(dim=DIM, codebook_size=32, image_size=IMAGE, patch_size=PATCH,
               temporal_patch_size=TPATCH, num_frames=FRAMES, spatial_depth=1,
               temporal_depth=1, dim_head=8, heads=2)
    bert = dict(vocab_size=40, hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                intermediate_size=32, hidden_dropout=0.0, attention_dropout=0.0)
    top = dict(dim_text=16, dim_image=4 * DIM, dim_latent=12)
    jcfg = J.CTCLIPConfig(**top, ctvit=J.CTViTConfig(**vit, vq_exact_sim=True),
                          bert=J.BertConfig(**bert))
    pcfg = P.CTCLIPConfig(**top, ctvit=P.CTViTConfig(**vit), bert=P.BertConfig(**bert))
    g = torch.Generator().manual_seed(3)
    model = CTCLIP(pcfg).init_weights(g)
    rng = np.random.RandomState(3)
    video = _video(4)
    mask = (np.arange(10)[None] < np.array([[10], [6]])).astype(np.int64)
    ids = np.where(mask > 0, rng.randint(5, 40, (B, 10)), 0)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() <= 1:
                p.add_(0.2 * torch.randn(p.shape, generator=g))
        vt = model.visual_transformer
        tokens = vt.encode(vt.embed_patches(torch.from_numpy(video), train=True))
        assert tokens.shape == (B, 3, 2, 2, DIM)
        embed = vt.vq._codebook.embed
        embed[: B * 12] = tokens.reshape(-1, DIM)
        embed.copy_(embed / embed.norm(dim=-1, keepdim=True))
    variables = ctclip_params_from_torch(model.state_dict(), jcfg)
    jmodel = JCTCLIP(jcfg, dtype=jnp.float32)

    def loss_fn(params, vq):
        loss, new = jmodel.apply({"params": params, "vq": vq}, jnp.asarray(ids),
                                 jnp.asarray(mask), jnp.asarray(video), return_loss=True,
                                 train=True, mutable=["vq"])
        return loss, new["vq"]
    (jloss, new_vq), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"], variables["vq"])
    model.train()
    loss = model(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(video),
                 return_loss=True, train=True)
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    loss.backward()
    want = state_dict_from_jax({"params": grads, "vq": new_vq}, pcfg)
    params = [(n, p) for n, p in model.named_parameters() if p.numel() and n in want
              and "_extra" not in n]
    top_grad = max(want[n].abs().max().item() for n, _ in params)
    for name, p in params:
        grad = torch.zeros_like(p) if p.grad is None else p.grad  # the unused pooler
        if name.endswith(ZERO_GRAD + ("attention.self.key.bias",)):
            assert grad.abs().max().item() <= 1e-6 * top_grad, name
            continue
        _close(grad, want[name].numpy(), 1e-4)
    for key in ("embed", "cluster_size"):
        name = f"visual_transformer.vq._codebook.{key}"
        _close(model.state_dict()[name], want[name].numpy(), 1e-5)
