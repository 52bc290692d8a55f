"""Carry weights across from the JAX package.

`state_dict_from_jax` turns the JAX package's CTCLIP variables
{'params': ..., 'vq': ...} (any array type numpy can read) into a state dict
of the port's CTCLIP, which is the reference CT-CLIP torch layout.  It is the
inverse of ct_clip_tpu/convert/torch_to_jax.py::ctclip_params_from_torch:
Dense kernels (in, out) become Linear weights (out, in), flax Conv kernels
(kt, kh, kw, 1, c) become Conv3d weights (c, 1, kt, kh, kw).  Entries the
JAX tree does not hold are filled as the reference holds them: the zero
`beta` buffers of the gamma-only LayerNorms, the empty `null_kv`, the VQ
`initted` flag, and zero CLOOB `*_extra` projections when the JAX model was
built without them.  The auxiliary heads are carried when the JAX model
has them: `mlm.to_logits`, and the visual-SSL projector (fc0, bn0, fc1, bn1,
out; the closing bn_out has no parameters) and SimSiam predictor (fc0, bn0,
out) under the reference's nn.Sequential indices
(`visual_ssl.net.projector.{0,1,3,4,6}`, `visual_ssl.online_predictor.{0,1,3}`).

`ctvit_state_dict_from_jax` does it for a standalone CTViT, the
autoencoder's decoder included (its parameters carry the JAX package's
names, which mirror the encoder's: the reference's decoder is dead code), and
`discriminator_state_dict_from_jax` for the autoencoder trainer's
Discriminator3D (flax Conv kernels DHWIO become Conv3d weights OIDHW).

`state_dict_from_train_state` does it for the JAX pretraining TrainState
(ct_clip_tpu/train/train_step.py): its `params` and `vq` collections, the
codebook's EMA state included; gradients and Adam moments, which share the
params' tree, convert the same way (`state_dict_from_jax({"params": tree,
"vq": ...})`).

`radbert_state_dict_from_jax` does the same for the JAX RadBertClassifier's
params: the inverse of ct_clip_tpu/convert/torch_to_jax.py::
radbert_params_from_torch (the reference `model.*` RoBERTa and `fc1` head).

`maskgit_state_dict_from_jax` and `critic_state_dict_from_jax` do it for the
JAX MaskGit and TokenCritic params (the layout torch_to_jax.py's
`maskgit_transformer_from_torch` reads, :76-123: embeddings, the 3-D CPB,
`transformer.layers.{i}.{0,1,2,3}` with the cross attention's context_norm
and interleaved null key/values at "2", `to_logits`), and
`t5_state_dict_from_jax` for the JAX T5Encoder's params into HF
`T5EncoderModel` names: the inverse of
ct_clip_tpu/models/t5_encoder.py::convert_hf_t5_encoder.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..config import CTCLIPConfig, CTViTConfig, MaskGitConfig, RadBertConfig


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(sd: Dict, key: str, p: Mapping, bias: bool = True) -> None:
    sd[f"{key}.weight"] = _t(p["kernel"]).T.contiguous()
    if bias:
        sd[f"{key}.bias"] = _t(p["bias"])


def _ln(sd: Dict, key: str, scale, bias) -> None:
    sd[f"{key}.weight"] = _t(scale)
    sd[f"{key}.bias"] = _t(bias)


def _bert(sd: Dict, p: Mapping, cfg, prefix: str) -> None:
    e = p["embeddings"]
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        sd[f"{prefix}embeddings.{name}.weight"] = _t(e[name]["embedding"])
    _ln(sd, f"{prefix}embeddings.LayerNorm", e["ln_scale"], e["ln_bias"])
    for i in range(cfg.num_hidden_layers):
        lp, lk = p[f"layer_{i}"], f"{prefix}encoder.layer.{i}."
        for name in ("query", "key", "value"):
            _linear(sd, f"{lk}attention.self.{name}", lp["attention_self"][name])
        _linear(sd, f"{lk}attention.output.dense", lp["attention_output_dense"])
        _ln(sd, f"{lk}attention.output.LayerNorm", lp["attention_ln_scale"],
            lp["attention_ln_bias"])
        _linear(sd, f"{lk}intermediate.dense", lp["intermediate_dense"])
        _linear(sd, f"{lk}output.dense", lp["output_dense"])
        _ln(sd, f"{lk}output.LayerNorm", lp["output_ln_scale"],
            lp["output_ln_bias"])
    _linear(sd, f"{prefix}pooler.dense", p["pooler_dense"])


def _gamma(sd: Dict, key: str, gamma) -> None:
    sd[f"{key}.gamma"] = _t(gamma)
    sd[f"{key}.beta"] = torch.zeros(sd[f"{key}.gamma"].shape)


def _attention(sd: Dict, a: Mapping, key: str, heads: int, dim_head: int) -> None:
    """A QKNormAttention; its null key/values (empty for self-attention) and
    its context_norm (cross attention) when the JAX params hold them."""
    _gamma(sd, f"{key}.norm", a["norm"]["gamma"])
    if "context_norm" in a:
        _gamma(sd, f"{key}.context_norm", a["context_norm"]["gamma"])
    for name in ("to_q", "to_kv", "to_out"):
        _linear(sd, f"{key}.{name}", a[name], bias=False)
    sd[f"{key}.q_scale"] = _t(a["q_scale"])
    sd[f"{key}.k_scale"] = _t(a["k_scale"])
    sd[f"{key}.null_kv"] = (_t(a["null_kv"]) if "null_kv" in a
                            else torch.zeros(heads, 0, dim_head))


def _transformer(sd: Dict, p: Mapping, prefix: str, depth: int,
                 heads: int, dim_head: int) -> None:
    for i in range(depth):
        lk = f"{prefix}.layers.{i}"
        peg = p[f"layers_{i}_peg"]["dsconv"]
        sd[f"{lk}.0.dsconv.weight"] = _t(peg["kernel"]).permute(4, 3, 0, 1, 2).contiguous()
        sd[f"{lk}.0.dsconv.bias"] = _t(peg["bias"])
        _attention(sd, p[f"layers_{i}_attn"], f"{lk}.1", heads, dim_head)
        if f"layers_{i}_cross_attn" in p:
            _attention(sd, p[f"layers_{i}_cross_attn"], f"{lk}.2", heads, dim_head)
        f = p[f"layers_{i}_ff"]
        _ln(sd, f"{lk}.3.0", f["norm"]["scale"], f["norm"]["bias"])
        _linear(sd, f"{lk}.3.1", f["wi"], bias=False)
        _linear(sd, f"{lk}.3.4", f["wo"], bias=False)
    _gamma(sd, f"{prefix}.norm_out", p["norm_out"]["gamma"])


def _ssl_heads(sd: Dict, p: Mapping) -> None:
    for key, tree, layers in (
            ("visual_ssl.net.projector", p.get("projector"),
             (("fc0", 0), ("bn0", 1), ("fc1", 3), ("bn1", 4), ("out", 6))),
            ("visual_ssl.online_predictor", p.get("predictor"),
             (("fc0", 0), ("bn0", 1), ("out", 3)))):
        if tree is None:
            continue
        for name, idx in layers:
            layer = tree[name]
            if name.startswith("bn"):
                _ln(sd, f"{key}.{idx}", layer["scale"], layer["bias"])
            else:
                _linear(sd, f"{key}.{idx}", layer, bias="bias" in layer)


def _cpb(sd: Dict, key: str, cpb: Mapping) -> None:
    _linear(sd, f"{key}.net.0.0", cpb["net_0"])
    _linear(sd, f"{key}.net.1.0", cpb["net_1"])
    _linear(sd, f"{key}.net.2", cpb["net_out"])


def _ctvit(sd: Dict, v: Mapping, vq: Mapping, vc: CTViTConfig, prefix: str) -> None:
    """A CTViT's params `v` and VQ state `vq` under `prefix`; the decoder
    when the params hold one."""
    _ln(sd, f"{prefix}to_patch_emb.1", v["patch_norm_in_scale"], v["patch_norm_in_bias"])
    _linear(sd, f"{prefix}to_patch_emb.2", {"kernel": v["patch_proj_kernel"],
                                            "bias": v["patch_proj_bias"]})
    _ln(sd, f"{prefix}to_patch_emb.3", v["patch_norm_out"]["scale"],
        v["patch_norm_out"]["bias"])
    stages = [("enc_spatial_transformer", vc.spatial_depth),
              ("enc_temporal_transformer", vc.temporal_depth)]
    cpbs = ["spatial_rel_pos_bias"]
    if "to_pixels" in v:
        stages += [("dec_temporal_transformer", vc.temporal_depth),
                   ("dec_spatial_transformer", vc.spatial_depth)]
        cpbs.append("dec_spatial_rel_pos_bias")
        _linear(sd, f"{prefix}to_pixels", v["to_pixels"])
    for name in cpbs:
        _cpb(sd, f"{prefix}{name}", v[name])
    for stage, depth in stages:
        _transformer(sd, v[stage], f"{prefix}{stage}", depth, vc.heads, vc.dim_head)
    sd[f"{prefix}vq._codebook.embed"] = _t(vq["embed"]).reshape(vc.codebook_size, vc.dim)
    sd[f"{prefix}vq._codebook.cluster_size"] = _t(vq["cluster_size"]).reshape(
        vc.codebook_size)
    sd[f"{prefix}vq._codebook.initted"] = torch.ones(1)


def ctvit_state_dict_from_jax(variables: Mapping,
                              cfg: CTViTConfig) -> Dict[str, torch.Tensor]:
    """JAX CTViT variables {'params': ..., 'vq': {'vq': ...}} (the
    autoencoder's, decoder included) -> the port's CTViT state dict."""
    sd: Dict[str, torch.Tensor] = {}
    _ctvit(sd, variables["params"], variables["vq"]["vq"], cfg, "")
    return sd


def discriminator_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX Discriminator3D params -> the port's: flax Conv kernels (kd, kh,
    kw, in, out) become Conv3d weights (out, in, kd, kh, kw)."""
    return {f"{name}.{leaf}": (_t(p["kernel"]).permute(4, 3, 0, 1, 2).contiguous()
                               if leaf == "weight" else _t(p["bias"]))
            for name, p in params.items() for leaf in ("weight", "bias")}


def state_dict_from_jax(variables: Mapping, cfg: CTCLIPConfig) -> Dict[str, torch.Tensor]:
    """JAX CTCLIP variables -> the port's CTCLIP state dict (f32 tensors)."""
    p = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    _bert(sd, p["text_transformer"], cfg.bert, "text_transformer.")
    _ctvit(sd, p["visual_transformer"], variables["vq"]["visual_transformer"]["vq"],
           cfg.ctvit, "visual_transformer.")

    _linear(sd, "to_text_latent", p["to_text_latent"], bias=False)
    _linear(sd, "to_visual_latent", p["to_visual_latent"], bias=False)
    for name, width in (("to_text_latent_extra", cfg.dim_text),
                        ("to_visual_latent_extra", cfg.dim_image)):
        if name in p:
            _linear(sd, name, p[name], bias=False)
        else:
            sd[f"{name}.weight"] = torch.zeros(cfg.dim_latent, width)
    sd["temperature"] = _t(p["temperature"]).reshape(())
    if "mlm" in p:
        _linear(sd, "mlm.to_logits", p["mlm"]["to_logits"])
    if "visual_ssl" in p:
        _ssl_heads(sd, p["visual_ssl"])
    return sd


def state_dict_from_train_state(state, cfg: CTCLIPConfig) -> Dict[str, torch.Tensor]:
    """A JAX TrainState (anything with `.params` and `.vq`) -> the port's
    CTCLIP state dict."""
    return state_dict_from_jax({"params": state.params, "vq": state.vq}, cfg)


def radbert_state_dict_from_jax(params: Mapping,
                                cfg: RadBertConfig) -> Dict[str, torch.Tensor]:
    """JAX RadBertClassifier params {'encoder': ..., 'classifier': ...} ->
    the port's RadBertClassifier state dict (f32 tensors)."""
    sd: Dict[str, torch.Tensor] = {}
    _bert(sd, params["encoder"], cfg, "model.")
    _linear(sd, "fc1", params["classifier"])
    return sd


def _token_transformer(sd: Dict, p: Mapping, cfg: MaskGitConfig) -> None:
    sd["token_emb.weight"] = _t(p["token_emb"]["embedding"])
    sd["pos_emb.weight"] = _t(p["pos_emb"]["embedding"])
    _transformer(sd, p["transformer"], "transformer", cfg.depth, cfg.heads, cfg.dim_head)
    _linear(sd, "to_logits", p["to_logits"])


def maskgit_state_dict_from_jax(params: Mapping,
                                cfg: MaskGitConfig) -> Dict[str, torch.Tensor]:
    """JAX MaskGit params -> the port's MaskGit state dict (f32 tensors)."""
    sd: Dict[str, torch.Tensor] = {}
    _token_transformer(sd, params, cfg)
    _cpb(sd, "continuous_pos_bias", params["continuous_pos_bias"])
    return sd


def critic_state_dict_from_jax(params: Mapping,
                               cfg: MaskGitConfig) -> Dict[str, torch.Tensor]:
    """JAX TokenCritic params -> the port's TokenCritic state dict."""
    sd: Dict[str, torch.Tensor] = {}
    _token_transformer(sd, params, cfg)
    return sd


def t5_state_dict_from_jax(variables: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """JAX T5Encoder variables {'params': ...} (`cfg` a T5EncoderConfig of
    either package) -> the port's T5Encoder state dict in HF
    `T5EncoderModel` names, the embedding under both of its tied keys."""
    p = variables["params"]
    sd: Dict[str, torch.Tensor] = {
        "shared.weight": _t(p["shared"]["embedding"]),
        "encoder.embed_tokens.weight": _t(p["shared"]["embedding"]),
        "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
            _t(p["relative_attention_bias"]["embedding"]),
        "encoder.final_layer_norm.weight": _t(p["final_norm"]["weight"]),
    }
    ff_names = ("wi_0", "wi_1", "wo") if cfg.gated_gelu else ("wi", "wo")
    for i in range(cfg.num_layers):
        base = f"encoder.block.{i}.layer"
        for name in ("q", "k", "v", "o"):
            _linear(sd, f"{base}.0.SelfAttention.{name}", p[f"block_{i}_attn"][name],
                    bias=False)
        for name in ff_names:
            _linear(sd, f"{base}.1.DenseReluDense.{name}", p[f"block_{i}_ff"][name],
                    bias=False)
        sd[f"{base}.0.layer_norm.weight"] = _t(p[f"block_{i}_attn_norm"]["weight"])
        sd[f"{base}.1.layer_norm.weight"] = _t(p[f"block_{i}_ff_norm"]["weight"])
    return sd
