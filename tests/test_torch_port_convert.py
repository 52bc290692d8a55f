"""ct_clip_tpu_torch weight conversion, checkpoint loading and import hygiene
(CPU)."""
import subprocess
import sys

import numpy as np
import torch

TINY = dict(dim_text=32, dim_image=3 * 3 * 32, dim_latent=24)
VIT = dict(dim=32, codebook_size=64, image_size=24, patch_size=8,
           temporal_patch_size=2, num_frames=6, spatial_depth=2,
           temporal_depth=2, dim_head=16, heads=2)
BERT = dict(vocab_size=40, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=64)


def _port_model(seed=0):
    import ct_clip_tpu_torch as P
    from ct_clip_tpu_torch.models import CTCLIP

    cfg = P.CTCLIPConfig(**TINY, ctvit=P.CTViTConfig(**VIT),
                         bert=P.BertConfig(**BERT))
    model = CTCLIP(cfg).eval()
    model.init_weights(torch.Generator().manual_seed(seed))
    return cfg, model


def test_round_trip_through_the_jax_converter():
    import ct_clip_tpu as J
    from ct_clip_tpu.convert.torch_to_jax import ctclip_params_from_torch
    from ct_clip_tpu_torch.convert import state_dict_from_jax

    pcfg, model = _port_model()
    jcfg = J.CTCLIPConfig(**TINY, ctvit=J.CTViTConfig(**VIT),
                          bert=J.BertConfig(**BERT),
                          extra_latent_projection=True)
    sd = model.state_dict()
    back = state_dict_from_jax(ctclip_params_from_torch(sd, jcfg), pcfg)
    assert set(back) == set(sd)
    for key, value in sd.items():
        assert back[key].shape == value.shape, key
        assert torch.equal(back[key], value), key


def test_reference_checkpoint_package_loads(tmp_path):
    from ct_clip_tpu_torch.cli import load_reference_checkpoint

    _, src = _port_model(seed=1)
    _, dst = _port_model(seed=2)
    sd = {f"module.{k}": v for k, v in src.state_dict().items()}
    sd["module.text_transformer.embeddings.position_ids"] = torch.arange(64)[None]
    # a leading codebook-head axis, as some vector-quantize-pytorch versions store
    key = "module.visual_transformer.vq._codebook.embed"
    sd[key] = sd[key][None]
    torch.save({"model": sd, "optim": {}}, tmp_path / "ckpt.pt")
    load_reference_checkpoint(dst, str(tmp_path / "ckpt.pt"))
    for key, value in src.state_dict().items():
        assert torch.equal(dst.state_dict()[key], value), key


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import ct_clip_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert len(names) >= 20, names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'ct_clip_tpu.')))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


def test_random_init_is_seeded():
    _, a = _port_model(seed=3)
    _, b = _port_model(seed=3)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    emb = a.visual_transformer.vq._codebook.embed
    np.testing.assert_allclose(emb.norm(dim=-1).numpy(), 1.0, rtol=1e-5)
