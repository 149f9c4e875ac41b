"""CLIP guidance loss for text-conditioned NeRF (rand_pose training).

Port of ``flnerf_tpu/core/clip_guidance.py`` (parity target ngp-ours/nerf/
clip_utils.py CLIPLoss): negative cosine similarity between CLIP image
embeddings of rendered views and text embeddings (dreamfields-style).

Gated like LPIPS (core/metrics.py): the CLIP weights cannot be downloaded
offline, so ``clip_loss_fn`` returns None unless the ``clip`` package and
its cached weights are present.  The loss structure (resize + CLIP
normalization + cosine similarity, a random prompt a step) works with any
encoder with the (images [N, 3, 224, 224] -> [N, D]) contract and is
differentiable in torch throughout: a real encoder's gradient reaches the
render, where the reference's host callback would stop it.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

# CLIP's published preprocessing constants
_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def clip_preprocess(images: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 3] in [0,1] -> [N, 3, 224, 224] CLIP-normalized (the
    reference's T.Resize(224) + T.Normalize).  The resize is
    ``jax.image.resize(..., "bilinear")``'s: half-pixel centres, and a
    triangle filter widened by the scale when shrinking (antialias)."""
    x = images.permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(224, 224), mode="bilinear", align_corners=False,
                      antialias=True)
    mean = torch.as_tensor(_CLIP_MEAN, device=x.device)[:, None, None]
    std = torch.as_tensor(_CLIP_STD, device=x.device)[:, None, None]
    return (x - mean) / std


def _normalize(z: torch.Tensor) -> torch.Tensor:
    return z / torch.linalg.norm(z, dim=-1, keepdim=True)


class CLIPGuidance:
    """Text-guided loss: -cos(encode(render), encode(text)).

    ``image_encoder(images [N,3,224,224]) -> [N, D]`` and
    ``text_zs [T, D]`` are injected, so the structure works with any CLIP
    implementation (or a test stub)."""

    def __init__(self, image_encoder: Callable, text_zs: torch.Tensor):
        self.image_encoder = image_encoder
        self.text_zs = _normalize(text_zs)

    def __call__(self, images: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The loss of rendered ``images`` [N, H, W, 3].  With several
        prompts, one is drawn a call from ``generator`` (the reference draws
        from its key); without a generator the first prompt is used, as the
        reference does without a key."""
        zs = _normalize(self.image_encoder(clip_preprocess(images)))
        t = self.text_zs
        if t.shape[0] > 1:
            idx = 0
            if generator is not None:
                idx = int(torch.randint(0, t.shape[0], (1,), generator=generator,
                                        device=generator.device))
            t = t[idx:idx + 1]
        return -torch.mean(torch.sum(zs * t, -1))


def clip_loss_fn(texts: Sequence[str], name: str = "ViT-B/16",
                 device="cpu") -> Optional[CLIPGuidance]:
    """Build the guidance from the real CLIP if importable + weights cached
    locally; None otherwise (offline gate, like metrics.lpips_fn)."""
    try:
        import clip  # type: ignore
    except ImportError:
        return None
    try:
        model, _ = clip.load(name, device=device, jit=False)
    except (OSError, RuntimeError):     # no cached weights and no network
        return None
    model.eval()
    with torch.no_grad():
        text_zs = model.encode_text(clip.tokenize(list(texts)).to(device)).float()
    return CLIPGuidance(lambda images: model.encode_image(images).float(), text_zs)
