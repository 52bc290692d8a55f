"""The port's RadBERT report classifier against the JAX package, on the CPU,
in f32: model, loss, gradients, trainer, metrics, converter and CLI.

Weights go from JAX to the port through `radbert_state_dict_from_jax`;
inputs are made from a seed with numpy.  Token ids use the WordPiece
convention of both CLIs ([PAD] = 0) against RadBertConfig.pad_token_id 1, so
pads count in RoBERTa's position cumsum and positions run to n + 1: the
tiny config keeps max_position_embeddings >= n + 2.

The key projection's bias has a gradient that is zero in exact arithmetic
(adding q.c to every score of a row leaves its softmax unchanged), so both
frameworks return rounding noise there (~1e-9 against gradients of ~1e-1);
the tests hold it to zero within that noise instead of comparing two noises.
"""
import csv
import json
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ct_clip_tpu.config import PATHOLOGIES
from ct_clip_tpu.config import RadBertConfig as JaxRadBertConfig
from ct_clip_tpu.models import RadBertClassifier as JaxRadBertClassifier
from ct_clip_tpu_torch.config import RadBertConfig
from ct_clip_tpu_torch.convert import radbert_state_dict_from_jax
from ct_clip_tpu_torch.models import RadBertClassifier

TINY = dict(vocab_size=40, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=40, hidden_dropout=0.0,
            attention_dropout=0.0)
B, N = 4, 32
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "pleural", "effusion",
         "is", "present", "not", "no", "lung", "nodule", "findings", "normal",
         "chest", "ct", "."]


def _is_key_bias(name):
    return name.endswith("attention.self.key.bias")


def _port(params, **kw):
    model = RadBertClassifier(RadBertConfig(**{**TINY, **kw}))
    model.load_state_dict(radbert_state_dict_from_jax(params, model.config))
    return model


@pytest.fixture(scope="module")
def ref():
    """Seeded ids with WordPiece pads, labels, the JAX model's params, its
    logits, its bce loss and jax.grad of the loss (dropout rates 0 with
    deterministic=False, as the JAX trainer's step applies the model)."""
    from ct_clip_tpu.train.finetune import bce_with_logits

    rng = np.random.RandomState(0)
    lengths = rng.randint(5, N, B)
    mask = (np.arange(N)[None] < lengths[:, None]).astype(np.int32)
    ids = np.where(mask > 0, rng.randint(1, TINY["vocab_size"], (B, N)), 0)
    labels = (rng.rand(B, 18) < 0.3).astype(np.float32)
    model = JaxRadBertClassifier(JaxRadBertConfig(**TINY))
    jids, jmask, jlabels = jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(labels)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jids, jmask)["params"]

    def loss_fn(p):
        logits = model.apply({"params": p}, jids, jmask, deterministic=False,
                             rngs={"dropout": jax.random.PRNGKey(1)})
        return bce_with_logits(logits, jlabels), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return dict(ids=ids, mask=mask, labels=labels, params=params,
                logits=np.asarray(logits), loss=float(loss), grads=grads)


def _forward(model, ref, training=True):
    from ct_clip_tpu_torch.train import bce_with_logits

    model.train(training)
    logits = model(torch.from_numpy(ref["ids"]), torch.from_numpy(ref["mask"]),
                   torch.Generator().manual_seed(0))
    return logits, bce_with_logits(logits, torch.from_numpy(ref["labels"]))


def test_logits_and_loss_match_jax(ref):
    logits, loss = _forward(_port(ref["params"]), ref)
    err = np.abs(logits.detach().numpy() - ref["logits"]).max()
    assert err <= 1e-5 * np.abs(ref["logits"]).max()
    assert abs(loss.item() - ref["loss"]) <= 1e-6


def test_gradients_match_jax_grad(ref):
    model = _port(ref["params"])
    _, loss = _forward(model, ref)
    loss.backward()
    want = radbert_state_dict_from_jax(ref["grads"], model.config)
    assert set(want) == {n for n, _ in model.named_parameters()}
    top = max(v.abs().max().item() for v in want.values())
    for name, p in model.named_parameters():
        got, exp = p.grad.numpy(), want[name].numpy()
        if _is_key_bias(name):  # zero in exact arithmetic: rounding noise only
            assert np.abs(got).max() <= 1e-6 * top and np.abs(exp).max() <= 1e-6 * top
            continue
        err = np.abs(got - exp).max()
        assert err <= 1e-4 * np.abs(exp).max(), f"{name}: {err:.3e}"


def test_roberta_positions_count_wordpiece_pads(ref):
    """Pads ([PAD] = 0 != pad_token_id 1) take positions up to n + 1, as the
    JAX package computes them (models/bert.py:45-51)."""
    model = _port(ref["params"])
    ids = torch.from_numpy(ref["ids"])
    pos = model.model.position_ids(ids)
    keep = (ref["ids"] != 1).astype(np.int64)
    np.testing.assert_array_equal(pos.numpy(), np.cumsum(keep, 1) * keep + 1)
    assert pos.max().item() == N + 1


@pytest.mark.parametrize("attention_dropout,training,want", [
    (0.0, True, "fused_attention"), (0.1, False, "fused_attention"),
    (0.1, True, "fused_attention_kbias_dropout")])
def test_attention_path_follows_dropout_active(ref, monkeypatch, attention_dropout,
                                               training, want):
    """bert.py:82-105: K13 only when dropout is active (rate > 0 and
    training), K7 (backward K12) otherwise."""
    import ct_clip_tpu_torch.models.bert as bert

    calls = []
    for name in ("fused_attention", "fused_attention_kbias_dropout"):
        real = getattr(bert, name)
        monkeypatch.setattr(bert, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    model = _port(ref["params"], attention_dropout=attention_dropout)
    _forward(model, ref, training)
    assert calls == [want] * TINY["num_hidden_layers"]


def test_dropout_draws_from_the_generator(ref):
    model = _port(ref["params"], hidden_dropout=0.1, attention_dropout=0.1).train()
    ids, mask = torch.from_numpy(ref["ids"]), torch.from_numpy(ref["mask"])
    a = model(ids, mask, torch.Generator().manual_seed(3))
    b = model(ids, mask, torch.Generator().manual_seed(3))
    c = model(ids, mask, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError):
        model(ids, mask)  # training with dropout needs a generator
    model.eval()
    np.testing.assert_allclose(model(ids, mask).detach().numpy(), ref["logits"],
                               atol=1e-5 * np.abs(ref["logits"]).max())


def test_state_dict_round_trips_through_radbert_params_from_torch(ref):
    from ct_clip_tpu.convert.torch_to_jax import radbert_params_from_torch

    cfg = RadBertConfig(**TINY)
    back = radbert_params_from_torch(radbert_state_dict_from_jax(ref["params"], cfg),
                                     JaxRadBertConfig(**TINY))
    flat_a = jax.tree_util.tree_leaves_with_path(ref["params"])
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf))


def test_decayed_set_equals_no_decay_mask(ref):
    """The port's AdamW decay group is the JAX no_decay_mask's True set,
    mapped through the converter's names."""
    from ct_clip_tpu.train.text_classifier import no_decay_mask
    from ct_clip_tpu_torch.train.text_classifier import is_decayed, param_groups

    mask = jax.tree.map(lambda m, p: np.full(np.shape(p), m, np.float32),
                        no_decay_mask(ref["params"]), ref["params"])
    as_torch = radbert_state_dict_from_jax(mask, RadBertConfig(**TINY))
    want = {k for k, v in as_torch.items() if bool(v.all())}
    assert not any(bool(v.any()) and not bool(v.all()) for v in as_torch.values())
    model = RadBertClassifier(RadBertConfig(**TINY))
    assert {n for n, _ in model.named_parameters() if is_decayed(n)} == want
    groups = param_groups(model, 0.01)
    assert [g["weight_decay"] for g in groups] == [0.01, 0.0]
    assert sum(len(g["params"]) for g in groups) == len(list(model.parameters()))


def _reports_csv(path, n, seed=0):
    rng = np.random.RandomState(seed)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, ["report"] + list(PATHOLOGIES))
        w.writeheader()
        for i in range(n):
            text = ("pleural effusion is present. no lung nodule." if i % 2
                    else "normal chest ct. findings not present.")
            w.writerow({"report": text,
                        **{p: int(rng.rand() < 0.4) for p in PATHOLOGIES}})
    return str(path)


@pytest.fixture
def vocab(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(VOCAB) + "\n")
    return str(path)


def test_batches_match_jax_dataset(tmp_path, vocab):
    """Same shuffles and sentence-shuffle augmentation as the JAX dataset."""
    from ct_clip_tpu.data import WordPieceTokenizer as JaxTok
    from ct_clip_tpu.train.text_classifier import ReportClassificationDataset as JaxDS
    from ct_clip_tpu_torch.data import WordPieceTokenizer
    from ct_clip_tpu_torch.train import ReportClassificationDataset, sentence_shuffle

    path = _reports_csv(tmp_path / "r.csv", 10)
    ours = ReportClassificationDataset(path, augment_prob=0.5, seed=3)
    theirs = JaxDS(path, augment_prob=0.5, seed=3)
    for a, b in zip(ours.batches(WordPieceTokenizer(vocab), 4, 24, augment=True, seed=2),
                    theirs.batches(JaxTok(vocab), 4, 24, augment=True, seed=2)):
        for key in ("input_ids", "attention_mask", "labels"):
            np.testing.assert_array_equal(a[key], b[key])
    text = "One. Two. Three."
    assert sorted(sentence_shuffle(text, random.Random(0), 1.0).split()) == sorted(text.split())


def test_two_trainer_steps_match_jax_trainer(tmp_path, vocab):
    """Two AdamW steps (one epoch of 2 batches at lr 5e-3) of the port's
    trainer and of the JAX trainer from the same weights: every parameter
    within 1e-5 absolute.  The key biases, whose gradient is rounding noise
    that Adam's normalisation turns into steps of up to lr, are held to that
    bound (2 lr) instead."""
    from ct_clip_tpu.data import WordPieceTokenizer as JaxTok
    from ct_clip_tpu.train.text_classifier import (
        ReportClassificationDataset as JaxDS, TextClassifierTrainer as JaxTrainer)
    from ct_clip_tpu_torch.data import WordPieceTokenizer
    from ct_clip_tpu_torch.train import ReportClassificationDataset, TextClassifierTrainer

    kw = {**TINY, "vocab_size": len(VOCAB), "max_position_embeddings": 514}
    path = _reports_csv(tmp_path / "r.csv", 16)
    jtr = JaxTrainer(JaxRadBertClassifier(JaxRadBertConfig(**kw)), JaxTok(vocab),
                     lr=5e-3, batch_size=8)
    jds = JaxDS(path)
    jtr._init(next(jds.batches(jtr.tokenizer, 8, shuffle=False)))
    start = radbert_state_dict_from_jax(jtr.params, RadBertConfig(**kw))
    jres = jtr.train(jds, epochs=1)

    model = RadBertClassifier(RadBertConfig(**kw))
    model.load_state_dict(start)
    tr = TextClassifierTrainer(model, WordPieceTokenizer(vocab), lr=5e-3, batch_size=8)
    res = tr.train(ReportClassificationDataset(path), epochs=1)
    assert res["history"][0]["train_loss"] == pytest.approx(
        jres["history"][0]["train_loss"], abs=1e-6)
    want = radbert_state_dict_from_jax(jtr.params, model.config)
    for name, p in model.state_dict().items():
        err = (p - want[name]).abs().max().item()
        if _is_key_bias(name):
            assert (p - start[name]).abs().max().item() <= 2 * 5e-3 * (1 + 1e-6)
            continue
        assert err <= 1e-5, f"{name}: {err:.3e}"


def test_epoch_learning_rates_match_jax_schedules():
    from ct_clip_tpu.train.text_classifier import TextClassifierTrainer as JaxTrainer
    from ct_clip_tpu_torch.train import TextClassifierTrainer

    model = RadBertClassifier(RadBertConfig(**TINY))
    jmodel = JaxRadBertClassifier(JaxRadBertConfig(**TINY))
    cawr = dict(scheduler="cawr", cawr_first_cycle=7, cawr_warmup=2, cawr_min_lr=1e-5)
    ours = TextClassifierTrainer(model, None, lr=5e-3, **cawr)
    theirs = JaxTrainer(jmodel, None, lr=5e-3, **cawr)
    np.testing.assert_allclose([ours._epoch_lr(e) for e in range(30)],
                               [theirs._epoch_lr(e) for e in range(30)], rtol=1e-12)
    rlop = dict(scheduler="rlop", rlop_patience=1, rlop_factor=0.1, rlop_min_lr=1e-5)
    ours = TextClassifierTrainer(model, None, lr=1e-3, **rlop)
    theirs = JaxTrainer(jmodel, None, lr=1e-3, **rlop)
    for loss in (1.0, 1.0, 1.0, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.4):
        ours._rlop_step(loss)
        theirs._rlop_step(loss)
        assert ours._epoch_lr(0) == theirs._epoch_lr(0)
        assert (ours._rlop_bad, ours._rlop_best) == (theirs._rlop_bad, theirs._rlop_best)
    assert ours._epoch_lr(0) == pytest.approx(1e-5)
    with pytest.raises(ValueError):
        TextClassifierTrainer(model, None, scheduler="step")


def test_metrics_match_sklearn_and_jax_report():
    from sklearn.metrics import accuracy_score, f1_score, multilabel_confusion_matrix
    from ct_clip_tpu.train.text_classifier import multilabel_report as jax_report
    from ct_clip_tpu_torch.evals import metrics
    from ct_clip_tpu_torch.train import multilabel_report

    rng = np.random.RandomState(9)
    labels = (rng.rand(30, 18) < 0.3).astype(np.float32)
    probs = np.clip(labels * 0.6 + rng.rand(30, 18) * 0.5, 0, 1)
    labels[:, 3], probs[:, 3] = 0, 0.1    # a class with no positives at all
    probs[:, 5] = 0.2                     # a class never predicted
    probs[7] = 0.0                        # a sample with no predictions
    preds = (probs >= 0.5).astype(int)
    for avg in ("macro", "micro"):
        assert metrics.f1_score(labels, preds, average=avg) == pytest.approx(
            f1_score(labels, preds, average=avg, zero_division=0), abs=1e-12)
    assert metrics.accuracy_score(labels.flatten(), preds.flatten()) == pytest.approx(
        accuracy_score(labels.flatten(), preds.flatten()), abs=1e-12)
    np.testing.assert_array_equal(metrics.multilabel_confusion_matrix(labels, preds),
                                  multilabel_confusion_matrix(labels, preds))
    ours, theirs = multilabel_report(labels, probs), jax_report(labels, probs)
    np.testing.assert_array_equal(ours["confusion"], theirs["confusion"])
    assert list(ours["report"]) == list(theirs["report"])
    for key, row in theirs["report"].items():
        assert list(ours["report"][key]) == list(row)
        np.testing.assert_allclose(list(ours["report"][key].values()),
                                   list(row.values()), atol=1e-12)
    json.dumps(ours["report"])  # the CLI writes it as JSON


def test_cli_radbert_train_infer_eval_on_cpu(tmp_path, vocab, monkeypatch):
    """radbert-train (with validation) -> .pt -> radbert-infer CSV ->
    radbert-eval JSON, with --device cpu and a tiny config."""
    import ct_clip_tpu_torch.config as config
    from ct_clip_tpu_torch.cli import main

    real = config.RadBertConfig
    monkeypatch.setattr(config, "RadBertConfig", lambda vocab_size: real(
        vocab_size=vocab_size, hidden_size=16, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=32))
    reports = _reports_csv(tmp_path / "reports.csv", 8)
    valid = _reports_csv(tmp_path / "valid.csv", 4, seed=1)
    head = tmp_path / "radbert.pt"
    base = ["--vocab", vocab, "--device", "cpu"]
    result = main(base + ["radbert-train", "--reports", reports, "--reports-valid", valid,
                          "--epochs", "2", "--batch-size", "4", "--out", str(head)])
    assert len(result["history"]) == 2 and np.isfinite(result["best_loss"])
    assert {"valid_loss", "f1_macro", "f1_micro", "accuracy"} <= set(result["history"][0])
    sd = torch.load(head, weights_only=True)
    assert "fc1.weight" in sd and "model.pooler.dense.weight" in sd

    out_csv = tmp_path / "inferred.csv"
    main(base + ["radbert-infer", "--reports", reports, "--head", str(head),
                 "--out", str(out_csv)])
    rows = list(csv.DictReader(open(out_csv)))
    assert len(rows) == 8 and set(PATHOLOGIES) <= set(rows[0])

    out_json = tmp_path / "report.json"
    probs = main(base + ["radbert-eval", "--reports", reports, "--head", str(head),
                         "--out", str(out_json)])
    assert probs.shape == (8, 18) and ((probs >= 0) & (probs <= 1)).all()
    rep = json.loads(out_json.read_text())
    assert PATHOLOGIES[0] in rep and "samples avg" in rep
