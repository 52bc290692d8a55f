"""Text-to-volume generation: the frozen CTViT autoencoder, MaskGit (and
optionally a critic) and a text embedder, with priming and scene chaining.

Port of ct_clip_tpu/models/pipeline.py (transformer_maskgit/
MaskGITTransformer.py:336-721).  Random draws come from `torch.Generator`s
(one seeded by the scene's index in `make_video`, as the JAX package keys
each scene with PRNGKey(i)).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .ctvit import CTViT
from .maskgit import MaskGit, sample_tokens


@dataclass
class MaskGITPipeline:
    ctvit: CTViT
    maskgit: MaskGit
    critic: Optional[nn.Module] = None
    # texts -> (b, n, d) embeddings with zeroed pad rows (models/t5.py)
    text_embed_fn: Optional[Callable[[Sequence[str]], torch.Tensor]] = None
    steps: int = 18
    cond_scale: float = 3.0
    starting_temperature: float = 0.9

    def _grid_for_frames(self, num_frames: int) -> Tuple[int, int, int]:
        cfg = self.ctvit.config
        return (num_frames // cfg.temporal_patch_size, cfg.patch_hw, cfg.patch_hw)

    @torch.no_grad()
    def encode_ids(self, video: torch.Tensor) -> torch.Tensor:
        """(b, f, H, W, 1) volume -> (b, t, h, w) code ids."""
        return self.ctvit(video, return_only_codebook_ids=True)

    @torch.no_grad()
    def sample(self, *, num_frames: int, texts: Optional[Sequence[str]] = None,
               prime_frames: Optional[torch.Tensor] = None, batch_size: int = 1,
               cond_scale: Optional[float] = None,
               generator: Optional[torch.Generator] = None, draws=None) -> torch.Tensor:
        """MaskGITTransformer.sample (:415-557): (b, num_frames, H, W, 1) in
        the CTViT's compute dtype, after `prime_frames` (b, f, H, W, 1) when
        given; one volume per text.  `draws`: `sample_tokens`'."""
        context = None
        if texts is not None:
            if self.text_embed_fn is None:
                raise ValueError("MaskGITPipeline.sample with texts needs a text_embed_fn")
            context = torch.as_tensor(self.text_embed_fn(list(texts)))
            context = context.to(self.maskgit.to_logits.weight.device)
            batch_size = len(texts)
        prime_ids, prime_num_frames = None, 0
        if prime_frames is not None:
            prime_ids = self.encode_ids(prime_frames)
            prime_ids = prime_ids.reshape(prime_ids.shape[0], -1)
            prime_num_frames = prime_frames.shape[1]
        grid = self._grid_for_frames(num_frames + prime_num_frames)
        ids = sample_tokens(
            self.maskgit, grid, batch_size=batch_size, context=context, steps=self.steps,
            cond_scale=self.cond_scale if cond_scale is None else cond_scale,
            starting_temperature=self.starting_temperature, critic=self.critic,
            prime_token_ids=prime_ids, generator=generator, draws=draws)
        if prime_ids is not None:
            ids = torch.cat([prime_ids.to(ids.device).long(), ids], dim=-1)
        video = self.ctvit.decode_from_codebook_indices(ids, grid)
        return video[:, prime_num_frames:]

    def make_video(self, texts: List[str], num_frames,
                   prime_lengths) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """Scene chaining (MaskGITTransformer.py:698-721): each scene is
        primed with the tail frames of the one before; scene i samples
        from a generator seeded with i."""
        num_scenes = len(texts)
        if not isinstance(num_frames, (tuple, list)):
            num_frames = (num_frames,) * num_scenes
        if not isinstance(prime_lengths, (tuple, list)):
            prime_lengths = (prime_lengths,) * (num_scenes - 1)
        prime_lengths = (*prime_lengths, 0)
        dev = self.maskgit.to_logits.weight.device
        scenes: List[torch.Tensor] = []
        video_prime = None
        for i, (text, scene_frames, next_prime) in enumerate(
                zip(texts, num_frames, prime_lengths)):
            video = self.sample(texts=[text], prime_frames=video_prime,
                                num_frames=scene_frames,
                                generator=torch.Generator(device=dev).manual_seed(i))
            scenes.append(video)
            if next_prime:
                video_prime = video[:, -next_prime:]
        return torch.cat(scenes, dim=1), scenes
