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
built without them.

`state_dict_from_train_state` does it for the JAX pretraining TrainState
(ct_clip_tpu/train/train_step.py): its `params` and `vq` collections, the
codebook's EMA state included; gradients and Adam moments, which share the
params' tree, convert the same way (`state_dict_from_jax({"params": tree,
"vq": ...})`).

`radbert_state_dict_from_jax` does the same for the JAX RadBertClassifier's
params: the inverse of ct_clip_tpu/convert/torch_to_jax.py::
radbert_params_from_torch (the reference `model.*` RoBERTa and `fc1` head).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..config import CTCLIPConfig, RadBertConfig


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


def _transformer(sd: Dict, p: Mapping, prefix: str, depth: int,
                 heads: int, dim_head: int) -> None:
    for i in range(depth):
        lk = f"{prefix}.layers.{i}"
        peg = p[f"layers_{i}_peg"]["dsconv"]
        sd[f"{lk}.0.dsconv.weight"] = _t(peg["kernel"]).permute(4, 3, 0, 1, 2).contiguous()
        sd[f"{lk}.0.dsconv.bias"] = _t(peg["bias"])
        a = p[f"layers_{i}_attn"]
        _gamma(sd, f"{lk}.1.norm", a["norm"]["gamma"])
        for name in ("to_q", "to_kv", "to_out"):
            _linear(sd, f"{lk}.1.{name}", a[name], bias=False)
        sd[f"{lk}.1.q_scale"] = _t(a["q_scale"])
        sd[f"{lk}.1.k_scale"] = _t(a["k_scale"])
        sd[f"{lk}.1.null_kv"] = torch.zeros(heads, 0, dim_head)
        f = p[f"layers_{i}_ff"]
        _ln(sd, f"{lk}.3.0", f["norm"]["scale"], f["norm"]["bias"])
        _linear(sd, f"{lk}.3.1", f["wi"], bias=False)
        _linear(sd, f"{lk}.3.4", f["wo"], bias=False)
    _gamma(sd, f"{prefix}.norm_out", p["norm_out"]["gamma"])


def state_dict_from_jax(variables: Mapping, cfg: CTCLIPConfig) -> Dict[str, torch.Tensor]:
    """JAX CTCLIP variables -> the port's CTCLIP state dict (f32 tensors)."""
    p, vc = variables["params"], cfg.ctvit
    sd: Dict[str, torch.Tensor] = {}
    _bert(sd, p["text_transformer"], cfg.bert, "text_transformer.")

    v, vk = p["visual_transformer"], "visual_transformer"
    _ln(sd, f"{vk}.to_patch_emb.1", v["patch_norm_in_scale"], v["patch_norm_in_bias"])
    _linear(sd, f"{vk}.to_patch_emb.2", {"kernel": v["patch_proj_kernel"],
                                         "bias": v["patch_proj_bias"]})
    _ln(sd, f"{vk}.to_patch_emb.3", v["patch_norm_out"]["scale"],
        v["patch_norm_out"]["bias"])
    cpb = v["spatial_rel_pos_bias"]
    _linear(sd, f"{vk}.spatial_rel_pos_bias.net.0.0", cpb["net_0"])
    _linear(sd, f"{vk}.spatial_rel_pos_bias.net.1.0", cpb["net_1"])
    _linear(sd, f"{vk}.spatial_rel_pos_bias.net.2", cpb["net_out"])
    for stage, depth in (("enc_spatial_transformer", vc.spatial_depth),
                         ("enc_temporal_transformer", vc.temporal_depth)):
        _transformer(sd, v[stage], f"{vk}.{stage}", depth, vc.heads,
                     vc.dim_head)
    vq = variables["vq"]["visual_transformer"]["vq"]
    sd[f"{vk}.vq._codebook.embed"] = _t(vq["embed"]).reshape(vc.codebook_size, vc.dim)
    sd[f"{vk}.vq._codebook.cluster_size"] = _t(vq["cluster_size"]).reshape(vc.codebook_size)
    sd[f"{vk}.vq._codebook.initted"] = torch.ones(1)

    _linear(sd, "to_text_latent", p["to_text_latent"], bias=False)
    _linear(sd, "to_visual_latent", p["to_visual_latent"], bias=False)
    for name, width in (("to_text_latent_extra", cfg.dim_text),
                        ("to_visual_latent_extra", cfg.dim_image)):
        if name in p:
            _linear(sd, name, p[name], bias=False)
        else:
            sd[f"{name}.weight"] = torch.zeros(cfg.dim_latent, width)
    sd["temperature"] = _t(p["temperature"]).reshape(())
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
