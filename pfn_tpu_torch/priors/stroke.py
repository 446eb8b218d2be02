"""Stroke (synthetic MNIST-style) image-classification prior.

Port of ``pfn_tpu/priors/stroke.py`` (reference priors/stroke.py). Per batch
element, every class gets a stroke program: 1..3 strokes, each a start point,
a length and a direction. Each image renders its class's program with its
own stroke width, global offset, per-stroke endpoint jitter and per-pixel
brightness in [200/255, 1], then a 3-tap Gaussian blur. Labels are uniform
per position or, with ``only_train_for_last_idx``, a balanced shuffled
support set plus one query whose target is the only one not -100
(reference stroke.py:97-103; the CE criterion ignores -100).

As every port sampler, it splits into :meth:`StrokePrior.draw` (every random
draw, from a ``torch.Generator``) and the deterministic renderer
:meth:`StrokePrior.from_draws`, which the tests feed with the JAX prior's
replayed draws. The renderer keeps the JAX prior's design: of K candidate
(start, length, angle) triples per stroke the first whose endpoint is in
bounds (the first candidate if none is); the capsule cover clip(width/2 +
0.5 - dist, 0, 1) of each stroke's segment; the max over active strokes
times the brightness; the blur with zero padding (``jnp.convolve(...,
mode="same")``) along rows, then columns. It is batched over (B, T, S) on
the device, with no host loop.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


def gaussian_kernel1d(sigma: float, radius: int) -> torch.Tensor:
    """The normalised f32 Gaussian taps at -radius .. radius."""
    xs = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (xs / max(sigma, 1e-6)) ** 2)
    return k / k.sum()


@dataclasses.dataclass(frozen=True)
class StrokePrior:
    """``num_features`` must be a square (size^2); ``num_outputs`` is the
    number of classes (reference stroke.py:116-117 fixes it to 2)."""

    num_features: int = 784
    num_outputs: int = 2
    min_max_strokes: tuple = (1, 3)
    min_max_len: tuple = (5 / 28, 20 / 28)
    min_max_start: tuple = (2 / 28, 25 / 28)
    min_max_width: tuple = (1 / 28, 4 / 28)
    max_offset: float = 4 / 28
    max_target_offset: float = 2 / 28
    only_train_for_last_idx: bool = False
    normalize_x: bool = False
    blur_sigma: float = 0.2
    num_direction_candidates: int = 8  # replaces the reference's retry loop

    @property
    def size(self) -> int:
        size = math.isqrt(self.num_features)
        if size * size != self.num_features:
            raise ValueError("num_features needs to be the square of an integer.")  # reference stroke.py:88
        return size

    def _randint(self, lo: int, hi: int, shape, generator, device) -> torch.Tensor:  # lo .. hi inclusive
        return torch.randint(lo, hi + 1, shape, generator=generator, device=device)

    def draw_programs(self, shape, generator: torch.Generator | None = None, device=None) -> dict:
        """The draws of ``shape``-many stroke programs, one per entry, each
        of S = min_max_strokes[1] strokes with K candidates: ``num_strokes``
        (*shape), ``starts`` (*shape, S, K, 2), ``lengths`` and ``angles``
        (in [0, 2 pi)) (*shape, S, K)."""
        size, S, K = self.size, self.min_max_strokes[1], self.num_direction_candidates
        shape = tuple(shape)
        return {
            "num_strokes": self._randint(self.min_max_strokes[0], S, shape, generator, device),
            "starts": self._randint(int(size * self.min_max_start[0]), int(size * self.min_max_start[1]),
                                    shape + (S, K, 2), generator, device).float(),
            "lengths": self._randint(int(size * self.min_max_len[0]), int(size * self.min_max_len[1]),
                                     shape + (S, K), generator, device).float(),
            "angles": torch.rand(shape + (S, K), generator=generator, device=device) * (2 * math.pi),
        }

    def draw_renders(self, shape, generator: torch.Generator | None = None, device=None) -> dict:
        """The draws of ``shape``-many renders: ``width`` (*shape), ``offset``
        (*shape, 2), ``jitter`` (*shape, S, 2) and ``brightness`` (*shape,
        size, size) in [200/255, 1]."""
        size, S = self.size, self.min_max_strokes[1]
        shape = tuple(shape)
        off_max, tgt_max = int(size * self.max_offset), int(size * self.max_target_offset)
        lo = 200.0 / 255.0
        return {
            "width": self._randint(int(size * self.min_max_width[0]), int(size * self.min_max_width[1]), shape,
                                   generator, device).float(),
            "offset": self._randint(-off_max, off_max, shape + (2,), generator, device).float(),
            "jitter": self._randint(-tgt_max, tgt_max, shape + (S, 2), generator, device).float(),
            "brightness": torch.rand(shape + (size, size), generator=generator, device=device) * (1.0 - lo) + lo,
        }

    def draw(self, batch_size: int, seq_len: int, generator: torch.Generator | None = None, device=None) -> dict:
        """Every random draw of one batch, in the JAX prior's units: the
        class programs of :meth:`draw_programs` at (B, C); the labels,
        ``labels`` (B, T), or ``support`` (B, T-1) (the balanced classes,
        shuffled) and ``query`` (B,) with ``only_train_for_last_idx``; and
        the renders of :meth:`draw_renders` at (B, T)."""
        B, T, C = batch_size, seq_len, self.num_outputs
        d = self.draw_programs((B, C), generator, device)
        if self.only_train_for_last_idx:
            self._check_seq_len(T)
            support = torch.arange(C, device=device).repeat((T - 1) // C)
            d["support"] = support[torch.argsort(torch.rand((B, T - 1), generator=generator, device=device), dim=1)]
            d["query"] = self._randint(0, C - 1, (B,), generator, device)
        else:
            d["labels"] = self._randint(0, C - 1, (B, T), generator, device)
        d.update(self.draw_renders((B, T), generator, device))
        return d

    def _check_seq_len(self, seq_len: int) -> None:
        if (seq_len - 1) % self.num_outputs:
            raise ValueError(f"only_train_for_last_idx needs (seq_len - 1) % num_outputs == 0, got seq_len "
                             f"{seq_len} and {self.num_outputs} classes")  # reference stroke.py:90-91

    def programs(self, d: dict):
        """Each stroke's first in-bounds candidate of :meth:`draw_programs`'
        draws: start (*shape, S, 2), length and angle (*shape, S), and which
        strokes are active (*shape, S)."""
        size = self.size
        starts, lengths, angles = d["starts"], d["lengths"], d["angles"]
        ends = starts + lengths[..., None] * torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1)
        ok = ((ends >= 0) & (ends <= size - 1)).all(dim=-1)  # (*shape, S, K)
        first_ok = torch.argmax(ok.to(torch.int32), dim=-1, keepdim=True)  # the first True; 0 if none
        length = torch.gather(lengths, -1, first_ok)[..., 0]
        angle = torch.gather(angles, -1, first_ok)[..., 0]
        start = torch.gather(starts, -2, first_ok[..., None].expand(*first_ok.shape, 2))[..., 0, :]
        S = starts.shape[-3]
        active = torch.arange(S, device=starts.device) < d["num_strokes"][..., None]
        return start, length, angle, active

    def _labels(self, d: dict):
        if self.only_train_for_last_idx:
            labels = torch.cat([d["support"], d["query"][:, None]], dim=1)
            targets = torch.full_like(labels, -100)
            targets[:, -1] = d["query"]
            return labels, targets
        return d["labels"], d["labels"]

    def render(self, start, length, angle, active, r: dict) -> torch.Tensor:
        """Images (*shape, size, size) f32: the program of each image (start
        (*shape, S, 2), length, angle, active (*shape, S), as
        :meth:`programs` gives them) drawn with its render draws ``r`` (as
        :meth:`draw_renders` gives them at ``shape``)."""
        size = self.size
        a = start + r["offset"][..., None, :]
        b = a + length[..., None] * torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1) + r["jitter"]

        # Distance from each pixel (x, y) = (col, row), as PIL draws, to each
        # segment a-b: (*shape, S, H, W).
        grid = torch.arange(size, dtype=torch.float32, device=a.device)
        px, py = grid[None, :], grid[:, None]
        ab = b - a
        ax, ay = a[..., 0, None, None], a[..., 1, None, None]
        abx, aby = ab[..., 0, None, None], ab[..., 1, None, None]
        denom = torch.clamp_min((ab * ab).sum(dim=-1), 1e-8)[..., None, None]
        t = torch.clamp(((px - ax) * abx + (py - ay) * aby) / denom, 0.0, 1.0)
        dist = torch.sqrt((px - (ax + t * abx)) ** 2 + (py - (ay + t * aby)) ** 2)

        cover = torch.clamp(r["width"][..., None, None, None] / 2.0 + 0.5 - dist, 0.0, 1.0)
        cover = torch.where(active[..., None, None], cover, torch.zeros_like(cover)).amax(dim=-3)  # (*shape, H, W)
        img = cover * r["brightness"]

        # The separable blur, zero-padded: along each column, then each row.
        k = gaussian_kernel1d(self.blur_sigma, radius=1).to(img.device)
        img = F.pad(img, (0, 0, 1, 1))
        img = k[0] * img[..., :-2, :] + k[1] * img[..., 1:-1, :] + k[2] * img[..., 2:, :]
        img = F.pad(img, (1, 1))
        img = k[0] * img[..., :-2] + k[1] * img[..., 1:-1] + k[2] * img[..., 2:]
        if self.normalize_x:
            mean = img.mean(dim=(-2, -1), keepdim=True)
            std = img.std(dim=(-2, -1), keepdim=True, correction=0)
            img = (img - mean) / (std + 1e-6)
        return img.float()

    def from_draws(self, d: dict):
        """(x (B, T, size^2) f32, labels (B, T), targets (B, T)) from
        :meth:`draw`'s draws."""
        size = self.size
        start, length, angle, active = self.programs(d)
        labels, targets = self._labels(d)
        B = labels.shape[0]
        c = labels.to(torch.int64)
        rows = torch.arange(B, device=c.device)[:, None]
        img = self.render(start[rows, c], length[rows, c], angle[rows, c], active[rows, c], d)  # (B, T, H, W)
        return img.reshape(*img.shape[:2], size * size), labels.float(), targets.float()

    def sample(self, batch_size: int, seq_len: int, generator: torch.Generator | None = None, device=None):
        return self.from_draws(self.draw(batch_size, seq_len, generator, device))
