"""CT-CLIP pretraining in ct_clip_tpu_torch against the JAX package, f32, CPU.

Weights are initialised once in JAX (vectors moved off their init values, as
in test_torch_port_slice.py) and carried across with `state_dict_from_jax`;
inputs come from a numpy seed.  Both sides run the tiny configuration with
dropout 0 (dropout masks cannot match across generators).  The port runs its
plain versions; JAX, off the TPU, its XLA twins and the f32 VQ.

Tolerances, each relative to the largest entry of the reference tensor: loss
and logits 1e-5; gradients 1e-4 (f32 sums in other orders through two
towers); the VQ codebook and cluster sizes 1e-5.  The BERT key projection's
bias has a gradient that is zero in exact arithmetic (softmax shift
invariance), and so has the CPB MLP's output bias, which adds one constant
to every score of a head: both sides hold rounding noise there, held to 1e-6
of the largest gradient, and Adam turns that noise into steps of up to lr,
so their updates are held to that bound.  Updates are compared as deltas from
the start (lr 5e-3, well above f32 resolution of the weights) within 1e-5
absolute, except for entries whose gradient is below 1e-3 of its tensor's
largest: Adam's step divides by the running magnitude, so there a relative
rounding error of the gradient moves the step by up to lr, and they are held
to the bound 2 lr (the gradients themselves are held to 1e-4 of the largest
above).  Such noise-driven steps make the two sides' weights differ by up to
lr after one step, so the second step starts both from JAX's state.
"""
import csv
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

DIM, HEADS, DIM_HEAD = 32, 2, 16
IMAGE, PATCH, FRAMES, TPATCH = 24, 8, 6, 2
GRID = (IMAGE // PATCH) ** 2 * DIM  # 288
B, L, LR = 4, 16, 5e-3
VOCAB = 40


def _is_key_bias(name):
    """Parameters whose true gradient is zero (softmax shift invariance)."""
    return name.endswith(("attention.self.key.bias", "spatial_rel_pos_bias.net.2.bias"))


def _configs(**top):
    import ct_clip_tpu as J
    import ct_clip_tpu_torch as P

    vit = dict(dim=DIM, codebook_size=64, image_size=IMAGE, patch_size=PATCH,
               temporal_patch_size=TPATCH, num_frames=FRAMES, spatial_depth=1,
               temporal_depth=1, dim_head=DIM_HEAD, heads=HEADS)
    bert = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=1,
                num_attention_heads=2, intermediate_size=64,
                max_position_embeddings=512, hidden_dropout=0.0, attention_dropout=0.0)
    top = dict(dim_text=32, dim_image=GRID, dim_latent=24, **top)
    jcfg = J.CTCLIPConfig(**top, ctvit=J.CTViTConfig(**vit), bert=J.BertConfig(**bert))
    pcfg = P.CTCLIPConfig(**top, ctvit=P.CTViTConfig(**vit), bert=P.BertConfig(**bert))
    return jcfg, pcfg


def _batch(seed):
    rng = np.random.RandomState(seed)
    lengths = rng.randint(5, L, B)
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int32)
    ids = np.where(mask > 0, rng.randint(5, VOCAB, (B, L)), 0).astype(np.int32)
    ids[:, 0] = 2
    video = rng.uniform(-1, 1, (B, FRAMES, IMAGE, IMAGE, 1)).astype(np.float32)
    return dict(input_ids=ids, attention_mask=mask, video=video)


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return dict(input_ids=torch.from_numpy(batch["input_ids"]).long(),
                attention_mask=torch.from_numpy(batch["attention_mask"]).long(),
                video=torch.from_numpy(batch["video"]))


@pytest.fixture(scope="module")
def ref():
    from ct_clip_tpu.models import CTCLIP as JCTCLIP
    from ct_clip_tpu_torch.convert import state_dict_from_jax

    jcfg, pcfg = _configs()
    jmodel = JCTCLIP(jcfg, dtype=jnp.float32)
    b0 = _jax(_batch(0))
    variables = jax.jit(lambda key: jmodel.init(
        key, b0["input_ids"], b0["attention_mask"], b0["video"], return_loss=True))(
            jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.RandomState(0)
    variables["params"] = jax.tree_util.tree_map(
        lambda a: a + np.asarray(0.2 * rng.randn(*a.shape), a.dtype)
        if a.ndim <= 1 else a, variables["params"])
    start = state_dict_from_jax(variables, pcfg)
    jgrad = jax.jit(jax.value_and_grad(_jax_loss_fn(jmodel), has_aux=True))
    return dict(jmodel=jmodel, variables=variables, start=start, pcfg=pcfg, jcfg=jcfg,
                jgrad=jgrad)


def _port(ref, cfg=None):
    from ct_clip_tpu_torch.models import CTCLIP

    model = CTCLIP(cfg or ref["pcfg"])
    model.load_state_dict(ref["start"], strict=True)
    return model


def _jax_loss_fn(jmodel):
    def loss_fn(params, vq, batch):
        loss, new_vars = jmodel.apply(
            {"params": params, "vq": vq}, batch["input_ids"], batch["attention_mask"],
            batch["video"], return_loss=True, train=True, deterministic=False,
            rngs={"dropout": jax.random.PRNGKey(1)}, mutable=["vq"])
        return loss, new_vars["vq"]
    return loss_fn


def _vq_close(sd, want):
    for key in ("embed", "cluster_size"):
        name = f"visual_transformer.vq._codebook.{key}"
        err = (sd[name] - want[name]).abs().max().item()
        assert err <= 1e-5 * max(want[name].abs().max().item(), 1.0), f"{name}: {err:.3e}"


def test_vq_ids_agree_before_the_step(ref):
    """The step's comparisons need the same code ids on both sides."""
    from ct_clip_tpu.models import CTCLIP as JCTCLIP

    batch = _batch(1)
    _, jids, _ = ref["jmodel"].apply(
        ref["variables"], jnp.asarray(batch["video"]),
        method=lambda mod, v: mod.visual_transformer(v))
    vt = _port(ref).visual_transformer
    with torch.no_grad():
        tokens = vt.encode(vt.embed_patches(torch.from_numpy(batch["video"])))
        _, ids = vt.vq(tokens)
    np.testing.assert_array_equal(ids.reshape(B, -1).numpy(),
                                  np.asarray(jids).reshape(B, -1))
    assert JCTCLIP is not None


def test_loss_gradients_and_vq_state_match_jax(ref):
    from ct_clip_tpu_torch.convert import state_dict_from_jax

    batch = _batch(1)
    v = ref["variables"]
    (loss, new_vq), grads = ref["jgrad"](v["params"], v["vq"], _jax(batch))
    model = _port(ref)
    model.train()
    got = model(**_torch(batch), return_loss=True, train=True)
    assert abs(got.item() - float(loss)) <= 1e-5 * abs(float(loss))
    got.backward()
    want = state_dict_from_jax({"params": grads, "vq": new_vq}, ref["pcfg"])
    params = [(n, p) for n, p in model.named_parameters() if p.numel()]
    top = max(want[n].abs().max().item() for n, _ in params)
    for name, p in params:
        g = torch.zeros_like(p) if p.grad is None else p.grad
        if _is_key_bias(name):  # zero in exact arithmetic: rounding noise only
            assert g.abs().max().item() <= 1e-6 * top
            assert want[name].abs().max().item() <= 1e-6 * top
            continue
        err = (g - want[name]).abs().max().item()
        assert err <= 1e-4 * want[name].abs().max().item() + 1e-12, f"{name}: {err:.3e}"
    _vq_close(model.state_dict(), want)
    # the EMA moved the codebook: a non-trivial comparison
    moved = (want["visual_transformer.vq._codebook.embed"]
             - ref["start"]["visual_transformer.vq._codebook.embed"]).abs().max()
    assert moved > 1e-3


def _sync_from_jax(state, jstate, pcfg):
    """The port's state := the JAX state: parameters, VQ buffers, Adam moments."""
    from ct_clip_tpu_torch.convert import state_dict_from_jax, state_dict_from_train_state

    state.model.load_state_dict(state_dict_from_train_state(jstate, pcfg))
    adam = jstate.opt_state[1][0]
    mu, nu = (state_dict_from_jax({"params": t, "vq": jstate.vq}, pcfg)
              for t in (adam.mu, adam.nu))
    for name, p in state.model.named_parameters():
        st = state.optimizer.opt.state[p]
        st["exp_avg"].copy_(mu[name])
        st["exp_avg_sq"].copy_(nu[name])


def test_two_train_steps_match_jax_make_train_step(ref):
    """Two steps of `make_train_step` (global-norm clip 0.5, Adam betas (0.9,
    0.99), eps 1e-8) on two batches, each from the same state on both sides
    (the port's is set to JAX's after the first, moments included, so the
    second step's bias correction and moments are compared too): loss,
    grad_norm and temperature, every parameter's update and the VQ state."""
    from ct_clip_tpu.config import TrainConfig as JTrainConfig
    from ct_clip_tpu.train.optimizer import get_optimizer as jget
    from ct_clip_tpu.train.train_step import TrainState as JState
    from ct_clip_tpu.train.train_step import make_train_step as jmake
    from ct_clip_tpu_torch.config import TrainConfig
    from ct_clip_tpu_torch.convert import state_dict_from_jax, state_dict_from_train_state
    from ct_clip_tpu_torch.train import create_train_state, make_train_step

    v = ref["variables"]
    tx = jget(lr=LR, wd=0.0, max_grad_norm=0.5)
    jstate = JState(step=jnp.zeros((), jnp.int32), params=v["params"], vq=v["vq"],
                    opt_state=tx.init(v["params"]))
    jstep = jax.jit(jmake(ref["jmodel"], tx, JTrainConfig(lr=LR)))
    cfg = TrainConfig(lr=LR)
    state = create_train_state(_port(ref), cfg)
    step = make_train_step(cfg)
    for seed in (1, 2):
        if seed == 2:
            _sync_from_jax(state, jstate, ref["pcfg"])
        start = {k: t.clone() for k, t in state.model.state_dict().items()}
        _, grads = ref["jgrad"](jstate.params, jstate.vq, _jax(_batch(seed)))
        small = {n: g.abs() < 1e-3 * g.abs().max() for n, g in state_dict_from_jax(
            {"params": grads, "vq": jstate.vq}, ref["pcfg"]).items() if g.numel()}
        jstate, jm = jstep(jstate, _jax(_batch(seed)), jax.random.PRNGKey(seed))
        m = step(state, _torch(_batch(seed)))
        for key in ("loss", "grad_norm", "temperature"):
            assert abs(m[key].item() - float(jm[key])) <= 1e-5 * abs(float(jm[key])), key
        assert m["grad_norm"].item() > 0.5  # the clip was active
        want = state_dict_from_train_state(jstate, ref["pcfg"])
        for name, p in state.model.named_parameters():
            if not p.numel():
                continue
            delta = (p.detach() - start[name]).abs()
            if _is_key_bias(name):
                assert delta.max().item() <= LR * (1 + 1e-6)
                continue
            diff = (delta.new_tensor(0) + (p.detach() - start[name])
                    - (want[name] - start[name])).abs()
            assert diff[~small[name]].max().item() <= 1e-5, name
            if small[name].any():
                assert diff[small[name]].max().item() <= 2 * LR * (1 + 1e-6), name
        _vq_close(state.model.state_dict(), want)
    assert state.step == int(jstate.step) == 2
    assert state.optimizer.count == 2


def test_adamw_with_decay_mask_and_clip_matches_optax():
    """wd > 0: AdamW with decay on ndim >= 2 parameters only, behind the
    global-norm clip, two steps against the optax chain of get_optimizer."""
    import optax
    from ct_clip_tpu.train.optimizer import get_optimizer as jget
    from ct_clip_tpu_torch.train import get_optimizer

    rng = np.random.RandomState(11)
    params = {"w": rng.randn(3, 4).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(2)]
    tx = jget(lr=0.1, wd=0.05, max_grad_norm=0.5)
    jp, state = {k: jnp.asarray(v) for k, v in params.items()}, None
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = get_optimizer(tp.values(), lr=0.1, wd=0.05, max_grad_norm=0.5)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = opt.step()
        assert abs(norm.item() - float(optax.global_norm(g))) <= 1e-6 * norm.item()
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), atol=1e-6)


def test_cosine_lr_schedule_matches_jax():
    from ct_clip_tpu.train.optimizer import cosine_lr_schedule as jsched
    from ct_clip_tpu_torch.train import cosine_lr_schedule

    # JAX evaluates the schedule in f32: within one f32 ulp of 1e-3
    ours, theirs = cosine_lr_schedule(1e-3, 5, 40), jsched(1e-3, 5, 40)
    np.testing.assert_allclose([ours(s) for s in range(45)],
                               [float(theirs(s)) for s in range(45)], rtol=0, atol=1.2e-10)


def test_cawr_schedule_matches_jax():
    """The MaskGIT trainer's warm restarts over three cycles, gamma 0.5,
    against the JAX package's jit form (f32)."""
    from ct_clip_tpu.train.optimizer import cawr_schedule as jsched
    from ct_clip_tpu_torch.train import cawr_schedule

    kw = dict(max_lr=1e-3, min_lr=1e-5, warmup_steps=3, gamma=0.5)
    ours, theirs = cawr_schedule(10, **kw), jsched(10, **kw)
    np.testing.assert_allclose([ours(s) for s in range(32)],
                               [float(theirs(s)) for s in range(32)], rtol=2e-6)


@pytest.mark.parametrize("kind", ["plain", "dcl", "cloob", "multiview"])
def test_contrastive_loss_matches_jax(kind):
    from ct_clip_tpu.models.ctclip import contrastive_loss as jloss
    from ct_clip_tpu_torch.models.ctclip import contrastive_loss

    rng = np.random.RandomState(7)
    m = n = 2 if kind == "multiview" else 1

    def lat(k):
        a = rng.randn(k, 5, 12).astype(np.float32)
        return a / np.linalg.norm(a, axis=-1, keepdims=True)

    tl, il = lat(m), lat(n)
    extra = (lat(m), lat(n)) if kind == "cloob" else None
    kw = dict(decoupled=kind == "dcl")
    jcl, jmv = jloss(jnp.asarray(tl), jnp.asarray(il), jnp.float32(2.5),
                     image_to_text_latents=None if extra is None
                     else tuple(map(jnp.asarray, extra)), **kw)
    cl, mv = contrastive_loss(torch.from_numpy(tl), torch.from_numpy(il),
                              torch.tensor(2.5), image_to_text_latents=None if extra is None
                              else tuple(map(torch.from_numpy, extra)), **kw)
    assert abs(cl.item() - float(jcl)) <= 1e-6 * abs(float(jcl))
    np.testing.assert_allclose(mv.numpy(), np.asarray(jmv), rtol=1e-6)
    assert mv.shape == (m * n - 1,)


def test_multiview_cloob_loss_of_the_model_matches_jax(ref):
    """The weighted total with CLOOB and a 2 x 2 multiview batch: the model's
    loss against the JAX model's, from the same weights."""
    import dataclasses

    jcfg = dataclasses.replace(ref["jcfg"], extra_latent_projection=True)
    pcfg = ref["pcfg"].replace(extra_latent_projection=True)
    from ct_clip_tpu.models import CTCLIP as JCTCLIP

    batch = _batch(3)
    jm = JCTCLIP(jcfg, dtype=jnp.float32)
    rng = np.random.RandomState(9)
    params = dict(ref["variables"]["params"])
    for name, width in (("to_text_latent_extra", 32), ("to_visual_latent_extra", GRID)):
        params[name] = {"kernel": (rng.randn(width, 24) / np.sqrt(width)).astype(np.float32)}
    variables = {"params": params, "vq": ref["variables"]["vq"]}
    jl = jm.apply(variables, *(_jax(batch)[k] for k in ("input_ids", "attention_mask",
                                                         "video")),
                  return_loss=True, num_batch_texts=2, num_batch_images=2)
    from ct_clip_tpu_torch.convert import state_dict_from_jax
    from ct_clip_tpu_torch.models import CTCLIP

    model = CTCLIP(pcfg).eval()
    model.load_state_dict(state_dict_from_jax(variables, pcfg))
    with torch.no_grad():
        got = model(**_torch(batch), return_loss=True, num_batch_texts=2,
                    num_batch_images=2)
    assert abs(got.item() - float(jl)) <= 1e-5 * abs(float(jl))


def test_cosine_vq_train_ema_matches_jax_module():
    """CosineVQ(train=True) on f32 rows against the JAX module applied with
    mutable=["vq"]: ids, the straight-through output, the EMA codebook (codes
    with no rows kept) and the cluster sizes."""
    from ct_clip_tpu.ops.vq import CosineVQ as JaxVQ
    from ct_clip_tpu_torch.ops.vq import CosineVQ

    rng = np.random.RandomState(5)
    dim, codes = 16, 64
    embed = rng.randn(codes, dim).astype(np.float32)
    embed /= np.linalg.norm(embed, axis=-1, keepdims=True)
    csize = rng.rand(codes).astype(np.float32)
    truth = rng.randint(0, 40, 300)  # codes 40-63 get no rows
    x = (embed[truth] * (0.5 + rng.rand(300, 1))
         + 0.05 * rng.randn(300, dim)).astype(np.float32)
    jvq = JaxVQ(dim=dim, codebook_size=codes)
    (jq, jids, _), new = jvq.apply({"vq": {"embed": jnp.asarray(embed),
                                           "cluster_size": jnp.asarray(csize)}},
                                   jnp.asarray(x), train=True, mutable=["vq"])
    vq = CosineVQ(dim, codes)
    vq._codebook.embed.copy_(torch.from_numpy(embed))
    vq._codebook.cluster_size.copy_(torch.from_numpy(csize))
    xt = torch.from_numpy(x).requires_grad_()
    q, ids = vq(xt, train=True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(jq), atol=1e-6)
    np.testing.assert_allclose(vq._codebook.embed.numpy(), np.asarray(new["vq"]["embed"]),
                               atol=1e-6)
    np.testing.assert_allclose(vq._codebook.cluster_size.numpy(),
                               np.asarray(new["vq"]["cluster_size"]), atol=1e-6)
    # codes without rows keep their entry (decay * e + (1 - decay) * e)
    np.testing.assert_allclose(vq._codebook.embed.numpy()[40:], embed[40:], atol=1e-6)
    g, = torch.autograd.grad(q.sum(), xt)  # straight-through: identity
    np.testing.assert_array_equal(g.numpy(), np.ones_like(x))


def test_checkpoint_resume_equals_continuous_run(ref, tmp_path):
    """Two steps in one run against one step, a save, a restore into a fresh
    model and optimizer, and the second step: identical weights, VQ state,
    optimizer moments and step; at most `max_to_keep` files are kept."""
    from ct_clip_tpu_torch.config import TrainConfig
    from ct_clip_tpu_torch.train import (CheckpointManager, create_train_state,
                                         make_train_step)

    cfg = TrainConfig(lr=LR)
    step = make_train_step(cfg)
    a = create_train_state(_port(ref), cfg)
    for seed in (1, 2):
        step(a, _torch(_batch(seed)))
    b = create_train_state(_port(ref), cfg)
    step(b, _torch(_batch(1)))
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    for s in (0, 1):  # older files that the limit drops
        mgr.save(s, b)
    mgr.save(1, b)
    c = create_train_state(_port(ref), cfg)
    mgr.save(3, c)
    assert mgr.steps() == [1, 3]
    mgr.restore(c, 1)
    assert c.step == 1
    step(c, _torch(_batch(2)))
    for name, t in a.model.state_dict().items():
        assert torch.equal(t, c.model.state_dict()[name]), name
    sa, sc = a.optimizer.state_dict(), c.optimizer.state_dict()
    assert sa["count"] == sc["count"] == 2
    for pid, st in sa["opt"]["state"].items():
        for k, t in st.items():
            assert torch.equal(t, sc["opt"]["state"][pid][k]), (pid, k)


def _write_corpus(root, n_train=4, n_valid=2):
    from ct_clip_tpu_torch.config import PATHOLOGIES
    from ct_clip_tpu_torch.data import write_volume

    rng = np.random.RandomState(3)
    out = {}
    for split, count in (("train", n_train), ("valid", n_valid)):
        names = []
        for i in range(count):
            name = f"{split}_{i}_a_1.nii.gz"
            folder = root / split / f"{split}_{i}" / f"{split}_{i}_a"
            folder.mkdir(parents=True)
            write_volume(folder / name, rng.randint(-1000, 1500, (20, 20, 8)).astype(np.int16))
            names.append(name)
        with open(root / f"reports_{split}.csv", "w", newline="") as f:
            w = csv.DictWriter(f, ["VolumeName", "Findings_EN", "Impressions_EN"])
            w.writeheader()
            w.writerows({"VolumeName": n, "Findings_EN": f"lung nodule {i}.",
                         "Impressions_EN": ""} for i, n in enumerate(names))
        with open(root / f"meta_{split}.csv", "w", newline="") as f:
            w = csv.DictWriter(f, ["VolumeName", "XYSpacing", "ZSpacing",
                                   "RescaleSlope", "RescaleIntercept"])
            w.writeheader()
            w.writerows({"VolumeName": n, "XYSpacing": "[1.0, 1.0]", "ZSpacing": "1.5",
                         "RescaleSlope": "1.0", "RescaleIntercept": "-24"} for n in names)
        out[split] = names
    with open(root / "labels.csv", "w", newline="") as f:
        w = csv.DictWriter(f, ["VolumeName"] + list(PATHOLOGIES))
        w.writeheader()
        w.writerows(dict(VolumeName=n, **{p: i % 2 for i, p in enumerate(PATHOLOGIES)})
                    for n in out["valid"])
    (root / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "lung", "nodule", "is", "present",
         "not", "."] + [f"w{i}" for i in range(VOCAB - 11)]) + "\n")


def test_cli_train_on_cpu_logs_evaluates_saves_and_resumes(ref, tmp_path, monkeypatch):
    """`cli train --device cpu` on the tiny config (4 training volumes, batch
    2, 3 steps): metrics.jsonl with finite losses, one mini evaluation on the
    2 validation volumes, a checkpoint at step 2; a second run to 4 steps
    resumes from it."""
    from ct_clip_tpu_torch import cli

    monkeypatch.setattr(cli, "CTCLIPConfig", lambda: ref["pcfg"])
    _write_corpus(tmp_path)
    out = tmp_path / "results"
    args = ["--no-bf16", "--device", "cpu", "--vocab", str(tmp_path / "vocab.txt"),
            "train", "--data-train", str(tmp_path / "train"),
            "--reports-train", str(tmp_path / "reports_train.csv"),
            "--meta-train", str(tmp_path / "meta_train.csv"),
            "--data-valid", str(tmp_path / "valid"),
            "--reports-valid", str(tmp_path / "reports_valid.csv"),
            "--meta-valid", str(tmp_path / "meta_valid.csv"),
            "--labels", str(tmp_path / "labels.csv"), "--results", str(out),
            "--batch-size", "2", "--workers", "2", "--save-results-every", "2",
            "--save-model-every", "2"]
    # CTReportDataset keeps the first 80% of the training volumes (3 of 4)
    trainer = cli.main(args + ["--steps", "3"])
    assert len(trainer.train_ds) == 3
    recs = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in recs if "loss" in r]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert [r["step"] for r in recs if "mini_eval_mean_auc" in r] == [2]
    assert (out / "mini_eval_step2.csv").exists()
    assert sorted(p.name for p in (out / "checkpoints").iterdir()) == ["step_2.pt"]
    trainer = cli.main(args + ["--steps", "4"])
    recs = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    assert any(r.get("resumed_from") == 2 for r in recs)
    assert trainer.state.step == 4
    assert sorted(p.name for p in (out / "checkpoints").iterdir()) == ["step_2.pt",
                                                                        "step_4.pt"]
