"""MaskGIT generative stack over CTViT codebook ids (GenerateCT stage 2).

Port of ct_clip_tpu/models/maskgit.py (transformer_maskgit/
MaskGITTransformer.py):
  * `MaskGit` (:103-211): bidirectional token transformer: token embedding
    with a trailing [MASK] id, learned absolute positions, a 3-D continuous
    position bias (MLP width dim_head), non-causal PEG, self-attention on
    K7 dense (K12b backward), cross attention to the text context with 2
    null key/values, K3 feed-forward, gradient shrink (alpha 0.1), logits
    over the codebook; classifier-free guidance through cond drop;
  * `TokenCritic` (:215-300) and `SelfCritic` (:305-334);
  * `maskgit_train_loss` and `critic_train_loss` (:567-694);
  * `sample_tokens` (:415-557): cosine remasking, gumbel sampling with an
    annealed temperature, critic or confidence scores, priming, CFG.

The JAX package draws from `jax.random` keys; here every draw comes from an
explicit `torch.Generator`, or is handed in as a tensor through `draws`
(the tests hand JAX's own draws across, as `mlm_draws` does for MLM).

Dispatch choice: when the caller gives no `video_mask`, `maskgit_train_loss`
passes None to the model, so its self-attention takes `fused_attention` (K7
dense forward, K12b backward).  The JAX package builds an all-True mask
there, which sends it to XLA's masked branch: the same function, as
where(all-True mask, sim, -inf) is the identity.  A real `video_mask` goes
to `sdpa`'s masked plain path on every device.

Module names reproduce the reference state-dict layout (`token_emb`,
`pos_emb`, `continuous_pos_bias.net.{0.0,1.0,2}`,
`transformer.layers.{i}.{0,1,2,3}`, `transformer.norm_out`, `to_logits`),
which ct_clip_tpu/convert/torch_to_jax.py reads.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import MaskGitConfig
from ..ops.attention import ContinuousPositionBias, MaskgitTransformer
from .ctvit import init_param_


def _uniform(shape, generator: Optional[torch.Generator], device, low: float = 0.0,
             high: float = 1.0) -> torch.Tensor:
    """U[low, high) f32 drawn on the generator's device, moved to `device`."""
    gdev = generator.device if generator is not None else device
    u = torch.rand(shape, generator=generator, device=gdev)
    return (u * (high - low) + low).to(device)


def gumbel_sample(logits: torch.Tensor, temperature: float = 1.0,
                  noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """argmax(logits / temperature + gumbel) over the last axis, gumbel =
    -log(-log(u + 1e-10) + 1e-10), u ~ U[1e-20, 1) (`noise`, or drawn);
    temperature 0: the plain argmax (MaskGITTransformer.py:86-92)."""
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    if noise is None:
        noise = _uniform(logits.shape, generator, logits.device, 1e-20, 1.0)
    gumbel = -torch.log(-torch.log(noise.float() + 1e-10) + 1e-10)
    return (logits.float() / max(temperature, 1e-10) + gumbel).argmax(dim=-1)


def cosine_schedule_mask(valid: torch.Tensor, steps: int,
                         draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Training mask (MaskGITTransformer.py:628-641): per row a random step
    s in [0, steps) gives the masking share cos(s pi / 2 / steps); the
    ceil(share x valid count) valid positions of highest uniform score are
    masked.  `draws`: (steps (b,), scores (b, n)), or drawn."""
    b, n = valid.shape
    dev = valid.device
    if draws is None:
        gdev = generator.device if generator is not None else dev
        step = torch.randint(0, steps, (b,), generator=generator, device=gdev).to(dev)
        scores = _uniform((b, n), generator, dev)
    else:
        step, scores = (t.to(dev) for t in draws)
    prob = torch.cos(step.float() * math.pi * 0.5 / steps)
    scores = torch.where(valid, scores.float(), -1e9)
    order = torch.argsort(-scores, dim=-1, stable=True)
    ranks = torch.empty((b, n), dtype=torch.long, device=dev)
    ranks.scatter_(1, order, torch.arange(n, device=dev).expand(b, n).contiguous())
    quota = torch.ceil(prob[:, None] * valid.sum(dim=-1, keepdim=True))
    return (ranks < quota) & valid


def _cond_keep(b: int, cond_drop_prob: float, keep: Optional[torch.Tensor],
               generator: Optional[torch.Generator], device) -> torch.Tensor:
    """The (b,) rows that keep their text: `keep`, or Bernoulli(1 - p)."""
    if keep is not None:
        return keep.to(device=device, dtype=torch.bool)
    return _uniform((b,), generator, device) < 1.0 - cond_drop_prob


class _TokenTransformer(nn.Module):
    """Token and position embeddings and the non-causal MaskGIT transformer
    shared by `MaskGit` and `TokenCritic`."""

    def __init__(self, config: MaskGitConfig, num_tokens: int, has_cross_attn: bool,
                 dtype: torch.dtype, device=None):
        super().__init__()
        cfg = self.config = config
        self.num_tokens, self.dtype = num_tokens, dtype
        self.token_emb = nn.Embedding(num_tokens + 1, cfg.dim, device=device)
        self.pos_emb = nn.Embedding(cfg.max_seq_len, cfg.dim, device=device)
        self.transformer = MaskgitTransformer(
            cfg.dim, cfg.depth, cfg.dim_head, cfg.heads, dim_context=cfg.t5_dim,
            has_cross_attn=has_cross_attn, peg_causal=False, device=device)

    @property
    def mask_id(self) -> int:
        return self.num_tokens

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Seeded random weights (`init_param_`), the null key/values
        N(0, 1) as the JAX package draws them."""
        for name, t in self.named_parameters():
            if name.endswith("null_kv"):
                t.normal_(0.0, 1.0, generator=generator)
            else:
                init_param_(name, t, generator)
        return self

    def _embed(self, token_ids: torch.Tensor) -> torch.Tensor:
        n = token_ids.shape[1]
        x = self.token_emb.weight.to(self.dtype)[token_ids]
        return x + self.pos_emb.weight[:n].to(self.dtype)[None]

    def _text_mask(self, context, text_mask, cond_drop_prob, keep, generator):
        if context is None:
            return None
        if text_mask is None:
            text_mask = (context != 0).any(dim=-1)
        if cond_drop_prob > 0:
            keep = _cond_keep(context.shape[0], cond_drop_prob, keep, generator,
                              context.device)
            text_mask = keep[:, None] & text_mask
        return text_mask

    def _dense(self, x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
        """A Dense in the compute dtype (flax's `dtype=`)."""
        return x @ layer.weight.to(x.dtype).t() + layer.bias.to(x.dtype)


class MaskGit(_TokenTransformer):
    """forward(token_ids (b, N), (t, h, w)) -> logits (b, N, num_tokens) in
    the compute dtype; token id `num_tokens` is [MASK]."""

    def __init__(self, config: MaskGitConfig, num_tokens: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(config, num_tokens, not config.unconditional, dtype, device)
        self.continuous_pos_bias = ContinuousPositionBias(config.dim_head, config.heads,
                                                          num_dims=3, device=device)
        self.to_logits = nn.Linear(config.dim, num_tokens, device=device)

    def forward(self, token_ids: torch.Tensor, video_patch_shape: Tuple[int, int, int],
                context: Optional[torch.Tensor] = None,
                text_mask: Optional[torch.Tensor] = None,
                video_mask: Optional[torch.Tensor] = None, cond_drop_prob: float = 0.0,
                keep: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                return_embeds: bool = False) -> torch.Tensor:
        """`context` (b, m, t5_dim) text embeddings with zeroed pad rows
        (`text_mask` defaults to their non-zero rows); with cond_drop_prob
        > 0 each row keeps its text with probability 1 - p (`keep` (b,)
        bool, or drawn from `generator`); `video_mask` (b, N) True attends;
        return_embeds: the transformer's output (b, N, dim) instead of the
        logits."""
        b, _ = token_ids.shape
        t, h, w = video_patch_shape
        text_mask = self._text_mask(context, text_mask, cond_drop_prob, keep, generator)
        x = self._embed(token_ids)
        x = x * 0.1 + x.detach() * 0.9  # gradient shrink (MaskGITTransformer.py:199)
        bias = self.continuous_pos_bias(t, h, w)
        x = self.transformer(x, (b, t, h, w), attn_bias=bias, context=context,
                             self_attn_mask=video_mask,
                             cross_attn_context_mask=text_mask)
        if return_embeds:
            return x
        return self._dense(x, self.to_logits)


class TokenCritic(_TokenTransformer):
    """Scores each token as likely fake: forward -> (b, N) logits
    (MaskGITTransformer.py:215-300); no position bias."""

    def __init__(self, config: MaskGitConfig, num_tokens: int, has_cross_attn: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(config, num_tokens, has_cross_attn, dtype, device)
        self.to_logits = nn.Linear(config.dim, 1, device=device)

    def forward(self, token_ids: torch.Tensor, video_patch_shape: Tuple[int, int, int],
                context: Optional[torch.Tensor] = None,
                text_mask: Optional[torch.Tensor] = None,
                video_mask: Optional[torch.Tensor] = None, cond_drop_prob: float = 0.0,
                keep: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, _ = token_ids.shape
        t, h, w = video_patch_shape
        text_mask = self._text_mask(context, text_mask, cond_drop_prob, keep, generator)
        x = self.transformer(self._embed(token_ids), (b, t, h, w), context=context,
                             self_attn_mask=video_mask, cross_attn_context_mask=text_mask)
        return self._dense(x, self.to_logits)[..., 0]


class SelfCritic(nn.Module):
    """A critic head over the MaskGit's own embeddings, no separate tower
    (MaskGITTransformer.py:305-334): its parameters are the generator's
    (`maskgit.*`) and the head `to_pred`.  Same scoring interface as
    TokenCritic, so `sample_tokens(critic=...)` takes either."""

    def __init__(self, maskgit: MaskGit, device=None):
        super().__init__()
        self.maskgit = maskgit
        self.to_pred = nn.Linear(maskgit.config.dim, 1, device=device)

    @classmethod
    def wrap(cls, maskgit: MaskGit, head_state: Optional[Dict] = None) -> "SelfCritic":
        """A SelfCritic over a trained generator (shared, not copied), with
        the head's state dict {"to_pred.weight", "to_pred.bias"} when given
        (SelfCritic.wrap_variables in the JAX package)."""
        critic = cls(maskgit, device=maskgit.to_logits.weight.device)
        if head_state is not None:
            critic.to_pred.load_state_dict({k.removeprefix("to_pred."): v
                                            for k, v in head_state.items()})
        return critic

    def forward(self, token_ids, video_patch_shape, context=None, text_mask=None):
        embeds = self.maskgit(token_ids, video_patch_shape, context=context,
                              text_mask=text_mask, return_embeds=True)
        return self.maskgit._dense(embeds, self.to_pred)[..., 0]


def forward_with_cond_scale(fn: Callable, cond_scale: float, *args, **kwargs):
    """Classifier-free guidance: null + (cond - null) * scale, the null pass
    with cond_drop_prob 1 (MaskGITTransformer.py:146-158)."""
    logits = fn(*args, cond_drop_prob=0.0, **kwargs)
    if cond_scale == 1:
        return logits
    null_logits = fn(*args, cond_drop_prob=1.0, **kwargs)
    return null_logits + (logits - null_logits) * cond_scale


def maskgit_train_loss(maskgit: MaskGit, codebook_ids: torch.Tensor,
                       video_patch_shape: Tuple[int, int, int],
                       context: Optional[torch.Tensor] = None,
                       text_mask: Optional[torch.Tensor] = None,
                       video_mask: Optional[torch.Tensor] = None,
                       cond_drop_prob: float = 0.25, steps: int = 18,
                       generator: Optional[torch.Generator] = None,
                       draws: Optional[Dict[str, torch.Tensor]] = None):
    """Masked-token cross entropy (MaskGITTransformer.py:628-661): (loss,
    (masked ids, mask, logits)).  `draws` {"step": (b,), "scores": (b, N),
    "keep": (b,)} replaces the generator's draws.  No `video_mask`: the
    model sees None (module docstring)."""
    b = codebook_ids.shape[0]
    flat = codebook_ids.reshape(b, -1).long()
    valid = (video_mask.bool() if video_mask is not None
             else torch.ones(flat.shape, dtype=torch.bool, device=flat.device))
    mask = cosine_schedule_mask(valid, steps, None if draws is None else
                                (draws["step"], draws["scores"]), generator)
    masked = torch.where(mask, maskgit.mask_id, flat)
    logits = maskgit(masked, video_patch_shape, context=context, text_mask=text_mask,
                     video_mask=video_mask, cond_drop_prob=cond_drop_prob,
                     keep=None if draws is None else draws.get("keep"), generator=generator)
    logp = F.log_softmax(logits.float(), dim=-1)
    token_logp = logp.gather(-1, flat[..., None])[..., 0]
    w = mask.float()
    loss = -(token_logp * w).sum() / torch.clamp_min(w.sum(), 1.0)
    return loss, (masked, mask, logits)


def critic_train_loss(critic: nn.Module, codebook_ids: torch.Tensor, logits: torch.Tensor,
                      mask: torch.Tensor, video_patch_shape: Tuple[int, int, int],
                      context: Optional[torch.Tensor] = None,
                      text_mask: Optional[torch.Tensor] = None,
                      sample_temperature: float = 1.0,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """BCE of the critic on real vs resampled tokens (MaskGITTransformer.py:
    663-694): the masked positions are resampled from the detached logits
    (gumbel, `draws["noise"]` U[1e-20, 1) of the logits' shape, or drawn)."""
    b = codebook_ids.shape[0]
    flat = codebook_ids.reshape(b, -1).long()
    pred_ids = gumbel_sample(logits.detach(), sample_temperature,
                             None if draws is None else draws["noise"], generator)
    critic_input = torch.where(mask, pred_ids, flat)
    scores = critic(critic_input, video_patch_shape, context=context,
                    text_mask=text_mask).float()
    labels = (flat != pred_ids).float()
    return -(labels * F.logsigmoid(scores) + (1 - labels) * F.logsigmoid(-scores)).mean()


@torch.no_grad()
def sample_tokens(maskgit: MaskGit, video_patch_shape: Tuple[int, int, int],
                  batch_size: int = 1, context: Optional[torch.Tensor] = None,
                  text_mask: Optional[torch.Tensor] = None, steps: int = 18,
                  cond_scale: float = 3.0, starting_temperature: float = 0.9,
                  critic: Optional[nn.Module] = None, noise_K: float = 1.0,
                  prime_token_ids: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[Sequence[Dict[str, torch.Tensor]]] = None) -> torch.Tensor:
    """Iterative confidence-based demasking (MaskGITTransformer.py:415-557):
    (b, N - prime) sampled code ids, long.  Each step re-masks the
    round(N cos(step / steps pi / 2)) least sure positions (critic score
    plus annealed noise, or 1 - the probability of the drawn id), predicts
    the masked ones with CFG (cond_scale, when a context is given) and
    gumbel sampling at an annealed temperature (argmax at the last step).
    `draws[step]`: {"gumbel": U[1e-20, 1) of the logits' shape, "noise":
    U[0, 1) (b, N - prime)} replaces the generator's draws."""
    t, h, w = video_patch_shape
    prime_len = 0 if prime_token_ids is None else prime_token_ids.shape[-1]
    n = t * h * w - prime_len
    dev = maskgit.to_logits.weight.device
    ids = torch.full((batch_size, n), maskgit.mask_id, dtype=torch.long, device=dev)
    mask = torch.ones((batch_size, n), dtype=torch.bool, device=dev)
    prime = None if prime_token_ids is None else prime_token_ids.to(dev).long()
    scores = None

    def with_prime(x):
        return x if prime is None else torch.cat([prime, x], dim=-1)

    for step in range(steps):
        d = None if draws is None else draws[step]
        steps_til_x0 = steps - (step + 1)
        if step > 0 and scores is not None:
            k = max(int(round(n * math.cos((step / steps) * math.pi * 0.5))), 1)
            # the k highest scores, ties to the lower index (jax.lax.top_k)
            idx = torch.argsort(-scores, dim=-1, stable=True)[:, :k]
            mask = torch.zeros_like(mask).scatter_(1, idx, True)

        ids = torch.where(mask, maskgit.mask_id, ids)
        input_ids = with_prime(ids)
        logits = maskgit(input_ids, video_patch_shape, context=context,
                         text_mask=text_mask).float()
        if cond_scale != 1 and context is not None:
            null_logits = maskgit(input_ids, video_patch_shape, context=context,
                                  text_mask=text_mask, cond_drop_prob=1.0).float()
            logits = null_logits + (logits - null_logits) * cond_scale
        logits = logits[:, prime_len:]

        temperature = starting_temperature * (steps_til_x0 / steps)
        pred_ids = gumbel_sample(logits, temperature, None if d is None else d["gumbel"],
                                 generator)
        ids = torch.where(mask, pred_ids, ids)

        if step < steps - 1:
            if critic is not None:
                scores = critic(with_prime(ids), video_patch_shape, context=context,
                                text_mask=text_mask).float()[:, prime_len:]
                u = (d["noise"].to(dev) if d is not None
                     else _uniform(scores.shape, generator, dev))
                scores = scores + noise_K * (u - 0.5) * (steps_til_x0 / steps)
            else:
                probs = logits.softmax(dim=-1)
                conf = probs.gather(-1, ids[..., None])[..., 0]
                scores = torch.where(mask, 1.0 - conf, -1e4)
    return ids
