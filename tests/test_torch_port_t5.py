"""The T5 text encoder and the text embedders of ct_clip_tpu_torch against the
JAX package, f32, CPU.

A tiny T5 (vocab 96, d_model 32, d_kv 8, 4 heads, d_ff 48, 2 layers, as
tests/test_t5.py sizes it) initialised in JAX and carried across with
`t5_state_dict_from_jax`.  Without a mask the port's attention takes
`fused_attention` with the (1, 4, n, n) position bias (K7's dense form on
the card, its plain version here), with a pad mask bias and key bias
together take `attention_plain`, as JAX takes XLA.  Tolerance: 1e-4 of the
largest entry (f32 sums in other orders through the stack); bucket ids
exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

RTOL = 1e-4
B, NTOK = 2, 24  # n > 2 * max_exact: the log-spaced buckets are reached


def _close(got, ref, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got.astype(np.float64) - ref).max()
    assert err <= rtol * np.abs(ref).max(), f"max abs err {err:.3e}"


def _cfg(gated=True):
    kw = dict(vocab_size=96, d_model=32, d_kv=8, num_heads=4, d_ff=48, num_layers=2,
              gated_gelu=gated)
    from ct_clip_tpu.models.t5_encoder import T5EncoderConfig as JCfg
    from ct_clip_tpu_torch.models.t5_encoder import T5EncoderConfig

    return JCfg(**kw), T5EncoderConfig(**kw)


def _models(gated, seed=0):
    """The JAX encoder and variables (every vector moved off its init), and
    the port's twin."""
    from ct_clip_tpu.models.t5_encoder import T5Encoder as JT5
    from ct_clip_tpu_torch.convert.from_jax import t5_state_dict_from_jax
    from ct_clip_tpu_torch.models.t5_encoder import T5Encoder

    jcfg, pcfg = _cfg(gated)
    jm = JT5(jcfg)
    ids = jnp.zeros((1, 8), jnp.int32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), ids)["params"]
    rng = np.random.RandomState(seed)
    params = jax.tree.map(lambda p: np.asarray(p) + (0.2 * rng.randn(*p.shape).astype(
        np.float32) if np.ndim(p) == 1 else 0.0), params)
    pm = T5Encoder(pcfg)
    pm.load_state_dict(t5_state_dict_from_jax({"params": params}, pcfg))
    return jm, {"params": params}, pm, jcfg


def _inputs(seed=3):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 96, (B, NTOK))
    mask = np.ones((B, NTOK), np.int64)
    mask[0, 17:] = 0
    mask[1, 9:] = 0
    return ids, mask


def test_relative_position_bucket_matches_jax():
    from ct_clip_tpu.models.t5_encoder import relative_position_bucket as jbucket
    from ct_clip_tpu_torch.models.t5_encoder import relative_position_bucket

    pos = np.arange(-300, 300)
    want = np.asarray(jbucket(jnp.asarray(pos), 32, 128))
    got = relative_position_bucket(torch.from_numpy(pos), 32, 128).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("gated,with_mask", [(True, False), (True, True), (False, True)])
def test_t5_encoder_matches_jax(gated, with_mask):
    """Final hidden states without a mask (dense position bias alone) and
    with a pad mask (position bias + key bias), gated-GELU and ReLU."""
    jm, variables, pm, _ = _models(gated)
    ids, mask = _inputs()
    want = jax.jit(jm.apply)(variables, jnp.asarray(ids),
                             jnp.asarray(mask) if with_mask else None)
    got = pm(torch.from_numpy(ids), torch.from_numpy(mask) if with_mask else None)
    _close(got, want)


def test_t5_state_dict_round_trip_through_hf_names():
    """The port's state dict, in HF T5EncoderModel names, fed to the JAX
    package's own `convert_hf_t5_encoder`, gives the port's outputs: the
    names are HF's (the embedding under both of its tied keys)."""
    from ct_clip_tpu.models.t5_encoder import convert_hf_t5_encoder

    jm, _, pm, jcfg = _models(True, seed=1)
    sd = pm.state_dict()
    assert torch.equal(sd["shared.weight"], sd["encoder.embed_tokens.weight"])
    ids, mask = _inputs(4)
    want = jm.apply(convert_hf_t5_encoder(sd, jcfg), jnp.asarray(ids), jnp.asarray(mask))
    _close(pm(torch.from_numpy(ids), torch.from_numpy(mask)), want)


def test_t5_state_dict_keys_are_hf_t5_encoder_models():
    """The port's keys and shapes are those of transformers' T5EncoderModel
    at the same config, so an HF state dict loads with load_state_dict."""
    transformers = pytest.importorskip("transformers")
    from ct_clip_tpu_torch.models.t5_encoder import T5Encoder

    _, pcfg = _cfg(True)
    hf = transformers.T5EncoderModel(transformers.T5Config(
        vocab_size=96, d_model=32, d_kv=8, num_heads=4, d_ff=48, num_layers=2,
        feed_forward_proj="gated-gelu", is_encoder_decoder=False, use_cache=False))
    want = {k: tuple(v.shape) for k, v in hf.state_dict().items()}
    pm = T5Encoder(pcfg)
    assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} == want
    pm.load_state_dict(hf.state_dict())


class _ToyTokenizer:
    """HF-call shaped: ids from the characters, 1 for kept tokens."""

    def __call__(self, texts, padding="longest", truncation=True, max_length=8):
        rows = [[(7 + 13 * i + ord(c)) % 96 for c in t[:max_length]]
                for i, t in enumerate(texts)]
        n = max_length if padding == "max_length" else max(map(len, rows))
        return {"input_ids": np.asarray([r + [0] * (n - len(r)) for r in rows], np.int32),
                "attention_mask": np.asarray([[1] * len(r) + [0] * (n - len(r))
                                              for r in rows], np.int32)}


def test_t5_embedder_matches_jax_and_zeroes_pad_rows():
    from ct_clip_tpu.models.t5 import jax_t5_embedder
    from ct_clip_tpu_torch.models.t5 import t5_embedder

    jm, variables, pm, jcfg = _models(True, seed=2)
    texts = ["lungs clear", "small left pleural effusion with atelectasis"]
    tok = _ToyTokenizer()
    want = jax_t5_embedder(jcfg, variables, tok, max_length=20)(texts)
    got = t5_embedder(pm, tok, max_length=20)(texts)
    _close(got, want)
    assert got.shape == (2, 20, 32) and not got[0, 11:].any()


def test_bert_text_embedder_matches_jax():
    """The CXR-BERT embedder (padding to max_length, pad rows zeroed) on a
    tiny BERT carried across from JAX."""
    import ct_clip_tpu as J
    from ct_clip_tpu.models import BertModel as JBert
    from ct_clip_tpu.models.t5 import bert_text_embedder as jembed
    from ct_clip_tpu_torch.config import BertConfig
    from ct_clip_tpu_torch.convert.from_jax import _bert
    from ct_clip_tpu_torch.models import BertModel
    from ct_clip_tpu_torch.models.t5 import bert_text_embedder

    kw = dict(vocab_size=96, hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
              intermediate_size=64, max_position_embeddings=32)
    jmodel = JBert(J.BertConfig(**kw))
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(5), jnp.zeros((1, 8), jnp.int32))
    sd = {}
    _bert(sd, variables["params"], BertConfig(**kw), "")
    model = BertModel(BertConfig(**kw)).eval()
    assert not model.load_state_dict(sd, strict=False).missing_keys
    texts = ["no nodules", "mild emphysema"]
    tok = _ToyTokenizer()
    want = jembed(jmodel, variables, tok, max_length=16)(texts)
    got = bert_text_embedder(model, tok, max_length=16)(texts)
    _close(got, want)
    assert got.shape == (2, 16, 32) and not got[0, 10:].any()
