"""The zero-shot slice of ct_clip_tpu_torch against the JAX package, f32, CPU.

Weights are initialised once in JAX and carried across with
`state_dict_from_jax`; inputs are made from a numpy seed and fed to both.
The token grid is cubic (t = h = w = 3), so the port runs its temporal stage
in the native grid layout with the rotated PEG while JAX, off the TPU, takes
the sequence-major path (ct_clip_tpu/models/ctvit.py:279-286): agreement
checks the rotated-PEG equivalence to the reference's memory
reinterpretation.  Tolerance: normwise relative, max|port - jax| <=
1e-4 * max|jax|.
"""
import csv

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

RTOL = 1e-4
DIM, HEADS, DIM_HEAD = 32, 2, 16
IMAGE, PATCH, FRAMES, TPATCH = 24, 8, 6, 2
GRID = (IMAGE // PATCH) ** 2 * DIM  # 288


def _close(got, ref, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got.astype(np.float64) - ref).max()
    assert err <= rtol * np.abs(ref).max(), f"max abs err {err:.3e}"


def _vocab():
    from ct_clip_tpu_torch.config import PATHOLOGIES
    from ct_clip_tpu_torch.data.tokenizer import WordPieceTokenizer
    from ct_clip_tpu_torch.inference import pathology_prompts

    basic = WordPieceTokenizer({"[UNK]": 0})._basic_tokenize
    words = sorted({w for p in pathology_prompts() for w in basic(p)})
    return ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words


def _configs(vocab_size):
    import ct_clip_tpu as J
    import ct_clip_tpu_torch as P

    vit = dict(dim=DIM, codebook_size=64, image_size=IMAGE, patch_size=PATCH,
               temporal_patch_size=TPATCH, num_frames=FRAMES, spatial_depth=2,
               temporal_depth=2, dim_head=DIM_HEAD, heads=HEADS)
    bert = dict(vocab_size=vocab_size, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=2, intermediate_size=64,
                max_position_embeddings=512)
    top = dict(dim_text=32, dim_image=GRID, dim_latent=24)
    jcfg = J.CTCLIPConfig(**top, ctvit=J.CTViTConfig(**vit),
                          bert=J.BertConfig(**bert, hidden_dropout=0.0,
                                            attention_dropout=0.0))
    pcfg = P.CTCLIPConfig(**top, ctvit=P.CTViTConfig(**vit),
                          bert=P.BertConfig(**bert))
    return jcfg, pcfg


@pytest.fixture(scope="module")
def slice_models(tmp_path_factory):
    from ct_clip_tpu.data import WordPieceTokenizer as JTok
    from ct_clip_tpu.models import CTCLIP as JCTCLIP
    from ct_clip_tpu_torch.convert import state_dict_from_jax
    from ct_clip_tpu_torch.data import WordPieceTokenizer
    from ct_clip_tpu_torch.models import CTCLIP

    vocab = _vocab()
    vocab_path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    vocab_path.write_text("\n".join(vocab) + "\n")
    jcfg, pcfg = _configs(len(vocab))
    jmodel = JCTCLIP(jcfg, dtype=jnp.float32)
    ids = jnp.zeros((1, 16), jnp.int32)
    video = jnp.zeros((1, FRAMES, IMAGE, IMAGE, 1))
    variables = jax.jit(lambda key: jmodel.init(
        key, ids, jnp.ones_like(ids), video, return_loss=False,
        return_latents=True))(jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    # move every vector and scalar off its init value (ones/zeros) so LN
    # scales, biases and the QK scales are exercised
    rng = np.random.RandomState(0)
    variables["params"] = jax.tree_util.tree_map(
        lambda a: a + np.asarray(0.2 * rng.randn(*a.shape), a.dtype)
        if a.ndim <= 1 else a, variables["params"])

    # state_dict_from_jax carries every weight the slice reads, the patch
    # embedding that both the volume (K8) and the patch-row (K4) routes use
    # included: the strict load would fail on a missing key
    port = CTCLIP(pcfg).eval()
    port.load_state_dict(state_dict_from_jax(variables, pcfg), strict=True)
    return dict(jmodel=jmodel, variables=variables, port=port,
                jtok=JTok(str(vocab_path)), tok=WordPieceTokenizer(str(vocab_path)))


def _video(seed, b=2):
    rng = np.random.RandomState(seed)
    return rng.uniform(-1, 1, (b, FRAMES, IMAGE, IMAGE, 1)).astype(np.float32)


def test_encode_image_matches_jax(slice_models):
    from ct_clip_tpu.models import CTCLIP as JCTCLIP

    m = slice_models
    video = _video(1)
    jlat, jenc = m["jmodel"].apply(m["variables"], jnp.asarray(video),
                                   method=JCTCLIP.encode_image)
    jpre = m["jmodel"].apply(
        m["variables"], jnp.asarray(video),
        method=lambda mod, v: mod.visual_transformer.encode(
            mod.visual_transformer.embed_patches(v)))
    vt = m["port"].visual_transformer
    with torch.no_grad():
        lat, enc = m["port"].encode_image(torch.from_numpy(video))
        pre = vt.encode(vt.embed_patches(torch.from_numpy(video)))
    _close(pre, jpre)   # continuous encoder output, before the VQ lookup
    _close(enc, jenc)   # quantized tokens: same code ids
    _close(lat, jlat)


def test_encode_image_from_patch_rows_matches_jax(slice_models):
    from ct_clip_tpu.models import CTCLIP as JCTCLIP
    from ct_clip_tpu_torch.ops.patch_embed import rearrange_patches

    m = slice_models
    video = _video(4)
    rows = rearrange_patches(torch.from_numpy(video[..., 0]), TPATCH, PATCH)
    assert rows.shape == (2, (FRAMES // TPATCH) * (IMAGE // PATCH) ** 2,
                          TPATCH * PATCH * PATCH)
    jlat, jenc = m["jmodel"].apply(m["variables"], jnp.asarray(rows.numpy()),
                                   method=JCTCLIP.encode_image)
    with torch.no_grad():
        lat, enc = m["port"].encode_image(rows)
        vlat, _ = m["port"].encode_image(torch.from_numpy(video))
    _close(enc, jenc)
    _close(lat, jlat)
    _close(lat, vlat, rtol=1e-5)  # the same model input by the volume route


def test_encode_text_matches_jax(slice_models):
    from ct_clip_tpu.models import CTCLIP as JCTCLIP

    m = slice_models
    enc = m["tok"](["Lung nodule is present.", "Emphysema is not present."],
                   max_length=24)
    jlat = m["jmodel"].apply(m["variables"], jnp.asarray(enc["input_ids"]),
                             jnp.asarray(enc["attention_mask"]),
                             method=JCTCLIP.encode_text)
    with torch.no_grad():
        lat = m["port"].encode_text(torch.from_numpy(enc["input_ids"]).long(),
                                    torch.from_numpy(enc["attention_mask"]))
    _close(lat, jlat)


def test_zero_shot_probabilities_match_jax(slice_models):
    from ct_clip_tpu.inference.zero_shot import \
        ZeroShotClassifier as JClassifier
    from ct_clip_tpu_torch.inference import ZeroShotClassifier

    m = slice_models
    video = _video(2)
    ref = JClassifier(m["jmodel"], m["variables"], m["jtok"]).score_batch(
        jnp.asarray(video))
    got = ZeroShotClassifier(m["port"], m["tok"]).score_batch(torch.from_numpy(video))
    assert got.shape == (2, 18)
    _close(got, ref)


def _write_corpus(root):
    from ct_clip_tpu_torch.config import PATHOLOGIES
    from ct_clip_tpu_torch.data import write_volume

    rng = np.random.RandomState(3)
    names = []
    for i, shape in enumerate([(20, 20, 8), (22, 18, 9), (20, 20, 8)]):
        name = f"valid_{i}_a_1.nii.gz"
        folder = root / "data" / f"valid_{i}" / f"valid_{i}_a"
        folder.mkdir(parents=True)
        vol = rng.randint(-1000, 1500, shape).astype(np.int16)  # (x, y, z)
        write_volume(folder / name, vol)
        names.append(name)
    with open(root / "reports.csv", "w", newline="") as f:
        w = csv.DictWriter(f, ["VolumeName", "Findings_EN", "Impressions_EN"])
        w.writeheader()
        w.writerows({"VolumeName": n, "Findings_EN": "normal",
                     "Impressions_EN": ""} for n in names)
    with open(root / "meta.csv", "w", newline="") as f:
        w = csv.DictWriter(f, ["VolumeName", "XYSpacing", "ZSpacing",
                               "RescaleSlope", "RescaleIntercept"])
        w.writeheader()
        w.writerows({"VolumeName": n, "XYSpacing": "[1.0, 1.0]",
                     "ZSpacing": "1.5", "RescaleSlope": "1.0",
                     "RescaleIntercept": "-24"} for n in names)
    with open(root / "labels.csv", "w", newline="") as f:
        w = csv.DictWriter(f, ["VolumeName"] + list(PATHOLOGIES))
        w.writeheader()
        w.writerows(dict(VolumeName=n, **{p: int(rng.rand() < 0.3)
                                          for p in PATHOLOGIES}) for n in names)
    return [str(root / x) for x in ("data", "reports.csv", "meta.csv", "labels.csv")]


def test_run_zero_shot_matches_jax(slice_models, tmp_path):
    from ct_clip_tpu.data import CTReportDatasetInfer as JDataset
    from ct_clip_tpu.inference import run_zero_shot as jax_run
    from ct_clip_tpu_torch.data import CTReportDatasetInfer
    from ct_clip_tpu_torch.inference import run_zero_shot

    m = slice_models
    paths = _write_corpus(tmp_path)
    ref = jax_run(m["jmodel"], m["variables"], m["jtok"], JDataset(*paths),
                  str(tmp_path / "jax"), batch_size=2, num_workers=2,
                  save_artifacts=False)
    out_dir = tmp_path / "port"
    got = run_zero_shot(m["port"], m["tok"], CTReportDatasetInfer(*paths),
                        str(out_dir), batch_size=2, num_workers=2)
    assert got["accessions"] == ref["accessions"]
    assert got["predicted"].shape == (3, 18)
    _close(got["predicted"], ref["predicted"])
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    saved = np.load(out_dir / "predicted_weights.npz")["data"]
    np.testing.assert_array_equal(saved, got["predicted"])
    assert (out_dir / "accessions.txt").read_text().split() == got["accessions"]
    header, row = (out_dir / "aurocs.csv").read_text().splitlines()
    assert header.split(",")[-1] == "mean_auc" and len(row.split(",")) == 19


def test_run_zero_shot_patch_rows_matches_jax(slice_models, tmp_path):
    """The patch-row route (K6 into the batch buffer, K4 embed) against JAX's
    own patch-row route, and against the port's volume route on the same
    corpus.  Three volumes at batch 2: the tail batch scores a buffer whose
    second slot still holds the first batch's rows."""
    from ct_clip_tpu.data import CTReportDatasetInfer as JDataset
    from ct_clip_tpu.inference import run_zero_shot as jax_run
    from ct_clip_tpu_torch.data import CTReportDatasetInfer
    from ct_clip_tpu_torch.inference import run_zero_shot

    m = slice_models
    paths = _write_corpus(tmp_path)
    ref = jax_run(m["jmodel"], m["variables"], m["jtok"], JDataset(*paths),
                  str(tmp_path / "jax"), batch_size=2, num_workers=2,
                  save_artifacts=False, patch_rows=True)
    runs = {rows: run_zero_shot(m["port"], m["tok"], CTReportDatasetInfer(*paths),
                                str(tmp_path / f"port_{rows}"), batch_size=2,
                                num_workers=2, patch_rows=rows)
            for rows in (True, False)}
    got = runs[True]
    assert got["accessions"] == ref["accessions"]
    assert got["predicted"].shape == (3, 18)
    _close(got["predicted"], ref["predicted"])
    _close(got["predicted"], runs[False]["predicted"], rtol=1e-5)
    assert (tmp_path / "port_True" / "aurocs.csv").exists()


def test_export_latents_matches_jax(slice_models, tmp_path):
    from ct_clip_tpu.data import CTReportDatasetInfer as JDataset
    from ct_clip_tpu.inference.latents import export_latents as jax_export
    from ct_clip_tpu_torch.data import CTReportDatasetInfer
    from ct_clip_tpu_torch.inference import export_latents

    m = slice_models
    paths = _write_corpus(tmp_path)
    ref = jax_export(m["jmodel"], m["variables"], m["jtok"], JDataset(*paths),
                     str(tmp_path / "jax"), num_workers=2,
                     target_shape=(FRAMES, IMAGE, IMAGE))
    got = export_latents(m["port"], m["tok"], CTReportDatasetInfer(*paths),
                         str(tmp_path / "port"), num_workers=2)
    assert sorted(got["image"]) == sorted(ref["image"]) and len(got["image"]) == 3
    grid = (FRAMES // TPATCH, IMAGE // PATCH, IMAGE // PATCH, DIM)
    for acc in ref["image"]:
        for kind, shape in (("image", grid), ("text", (24,))):
            saved = np.load(tmp_path / "port" / f"{kind}_latents" / f"{acc}.npz")["arr"]
            assert saved.shape == shape and saved.dtype == np.float32
            np.testing.assert_array_equal(saved, got[kind][acc])
            _close(saved, ref[kind][acc])


def test_cli_zero_shot_writes_artifacts(tmp_path, monkeypatch):
    from ct_clip_tpu_torch import cli

    vocab = _vocab()
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    _, pcfg = _configs(len(vocab))
    monkeypatch.setattr(cli, "CTCLIPConfig", lambda: pcfg)  # tiny, CPU-sized
    data, reports, meta, labels = _write_corpus(tmp_path)
    out_dir = tmp_path / "out"
    cli.main(["--no-bf16", "--device", "cpu", "--vocab", str(tmp_path / "vocab.txt"),
              "--seed", "3", "zero-shot", "--data", data, "--reports", reports,
              "--meta", meta, "--labels", labels, "--results", str(out_dir),
              "--batch-size", "2", "--workers", "2"])
    pred = np.load(out_dir / "predicted_weights.npz")["data"]
    assert pred.shape == (3, 18) and np.isfinite(pred).all()
    assert ((pred >= 0) & (pred <= 1)).all()
    assert len((out_dir / "accessions.txt").read_text().split()) == 3
    assert (out_dir / "aurocs.csv").exists()


def _cli_args(tmp_path, monkeypatch, *extra):
    from ct_clip_tpu_torch import cli

    vocab = _vocab()
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    _, pcfg = _configs(len(vocab))
    monkeypatch.setattr(cli, "CTCLIPConfig", lambda: pcfg)  # tiny, CPU-sized
    data, reports, meta, labels = _write_corpus(tmp_path)
    return ["--no-bf16", *extra, "--vocab", str(tmp_path / "vocab.txt"),
            "export-latents", "--data", data, "--reports", reports, "--meta", meta,
            "--labels", labels, "--results", str(tmp_path / "out"), "--workers", "2"]


def test_cli_export_latents_writes_artifacts(tmp_path, monkeypatch):
    from ct_clip_tpu_torch import cli

    cli.main(_cli_args(tmp_path, monkeypatch, "--device", "cpu"))
    for kind, shape in (("image", (3, 3, 3, DIM)), ("text", (24,))):
        files = sorted((tmp_path / "out" / f"{kind}_latents").glob("*.npz"))
        assert len(files) == 3
        for f in files:
            arr = np.load(f)["arr"]
            assert arr.shape == shape and np.isfinite(arr).all()


def test_cli_default_device_needs_cuda(tmp_path, monkeypatch, capsys):
    from ct_clip_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        cli.main(_cli_args(tmp_path, monkeypatch))
    assert exc.value.code != 0
    assert "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()
