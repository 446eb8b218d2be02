"""Omniglot class banks: the real data (from local files) and a synthetic
stand-in.

Port of ``pfn_tpu/data/omniglot.py`` (reference datasets/omniglot.py and the
preprocessing of datasets/omniglotNshot.py:97-105: grayscale, resize to
imgsz, scale to [0, 1], invert to MNIST style). A bank is one dense
``(num_classes, per_class, H, W)`` float32 tensor, split into train (the
first 1200 classes) and test (classes 1200 on) as omniglotNshot.py:136 does;
``alphabet_ids`` groups the classes by alphabet for the alphabet-grouped
episodes (omniglotNshot.py:38).

Loading the real data needs torchvision's ``omniglot-py`` files on local
disk: nothing is ever downloaded. :func:`synthetic_class_bank` renders
stroke-program alphabets with the stroke prior's renderer instead: one
program per class (:meth:`StrokePrior.draw_programs`), ``per_class``
jittered renders of it (:meth:`StrokePrior.draw_renders`,
:meth:`StrokePrior.render`), batched over classes and instances on the
device. As every port sampler it is a draw from a ``torch.Generator``
(:func:`draw_synthetic_bank`) and a deterministic map of the draws
(:func:`synthetic_bank_from_draws`), which the tests feed with the JAX bank's
replayed draws.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from pfn_tpu_torch.device import require_cuda
from pfn_tpu_torch.priors.stroke import StrokePrior


@dataclasses.dataclass
class ClassBank:
    """images: (num_classes, per_class, H, W) float32 in [0, 1] (MNIST
    style, ink 1); alphabet_ids: (num_classes,) int64, the alphabet of each
    class (for alphabet-grouped episodes). Both on one device."""

    images: torch.Tensor
    alphabet_ids: torch.Tensor

    @property
    def num_classes(self) -> int:
        return self.images.shape[0]

    def to(self, device) -> "ClassBank":
        return ClassBank(self.images.to(device), self.alphabet_ids.to(device))

    def split(self, num_train_classes: int = 1200, test_start: int | None = None):
        """(train, test) banks by class index (omniglotNshot.py:136: train =
        the first ``num_train_classes`` classes, test = classes 1200 on of the
        full 1623-class bank). ``test_start`` defaults to the reference's 1200
        where the bank is larger, else to ``num_train_classes``, so a smaller
        (synthetic) bank still gets a disjoint, non-empty test split."""
        if test_start is None:
            test_start = 1200 if self.num_classes > 1200 else num_train_classes
        if test_start < num_train_classes:
            raise ValueError(f"test classes [{test_start}:] would overlap train [:{num_train_classes}]")
        if test_start >= self.num_classes:
            raise ValueError("empty test split")
        train = ClassBank(self.images[:num_train_classes], self.alphabet_ids[:num_train_classes])
        return train, ClassBank(self.images[test_start:], self.alphabet_ids[test_start:])


def load_omniglot_class_bank(root: str = "omniglot", imgsz: int = 28) -> ClassBank:
    """The real Omniglot data as a ClassBank on the CPU.

    Needs torchvision's Omniglot files on disk under ``root``
    (``omniglot-py/images_background`` and ``images_evaluation``); never
    downloads. 1623 character classes of 20 drawings, processed as the
    reference does (resize, /255, invert: omniglotNshot.py:97-105).
    """
    from PIL import Image

    base = os.path.join(root, "omniglot-py")
    splits = ["images_background", "images_evaluation"]
    for s in splits:
        if not os.path.isdir(os.path.join(base, s)):
            raise FileNotFoundError(
                f"Omniglot data not found under {base!r}. This environment "
                "has no network access; place the torchvision omniglot-py "
                "directory there, or use synthetic_class_bank() for a "
                "hermetic stand-in."
            )
    classes, alphabet_ids = [], []
    alphabet_index = 0
    for s in splits:
        split_dir = os.path.join(base, s)
        for alphabet in sorted(os.listdir(split_dir)):
            adir = os.path.join(split_dir, alphabet)
            if not os.path.isdir(adir):
                continue
            for character in sorted(os.listdir(adir)):
                cdir = os.path.join(adir, character)
                imgs = []
                for fname in sorted(os.listdir(cdir))[:20]:
                    with Image.open(os.path.join(cdir, fname)) as im:
                        im = im.convert("L").resize((imgsz, imgsz))
                        arr = np.asarray(im, dtype=np.float32) / 255.0
                    imgs.append(1.0 - arr)  # invert to MNIST style
                classes.append(np.stack(imgs))
                alphabet_ids.append(alphabet_index)
            alphabet_index += 1
    return ClassBank(torch.from_numpy(np.stack(classes).astype(np.float32)),
                     torch.as_tensor(alphabet_ids, dtype=torch.int64))


def _bank_stroke_prior(imgsz: int) -> StrokePrior:
    return StrokePrior(num_features=imgsz * imgsz, num_outputs=1)


def draw_synthetic_bank(generator: torch.Generator, num_classes: int = 40, per_class: int = 20,
                        imgsz: int = 28) -> dict:
    """The random draws of a synthetic bank, on the generator's device: one
    stroke program per class (``programs``: :meth:`StrokePrior.draw_programs`
    at (num_classes,)), then the draws of each of its ``per_class`` renders
    (``renders``: :meth:`StrokePrior.draw_renders` at (num_classes,
    per_class))."""
    sp = _bank_stroke_prior(imgsz)
    device = generator.device
    programs = sp.draw_programs((num_classes,), generator, device)
    return {"programs": programs, "renders": sp.draw_renders((num_classes, per_class), generator, device)}


def synthetic_bank_from_draws(d: dict, imgsz: int = 28, classes_per_alphabet: int = 10) -> ClassBank:
    """The bank of :func:`draw_synthetic_bank`'s draws: every class's
    program rendered with each of its render draws, (num_classes, per_class,
    imgsz, imgsz), and ``alphabet_ids`` = class // classes_per_alphabet."""
    sp = _bank_stroke_prior(imgsz)
    start, length, angle, active = sp.programs(d["programs"])  # (N, S, ...)
    per_class = d["renders"]["width"].shape[1]

    def each(t):  # the class's program beside each of its renders
        return t[:, None].expand(t.shape[0], per_class, *t.shape[1:])

    images = sp.render(each(start), each(length), each(angle), each(active), d["renders"])
    ids = torch.arange(images.shape[0], device=images.device) // classes_per_alphabet
    return ClassBank(images, ids)


def synthetic_class_bank(seed: int = 0, num_classes: int = 40, per_class: int = 20, imgsz: int = 28,
                         classes_per_alphabet: int = 10, device=None) -> ClassBank:
    """A hermetic Omniglot stand-in on ``device`` (None: the current CUDA
    device, an error without a card): each class a stroke program, each
    instance a jittered render of it, from a generator seeded with ``seed``
    on that device."""
    device = require_cuda() if device is None else torch.device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    return synthetic_bank_from_draws(draw_synthetic_bank(generator, num_classes, per_class, imgsz), imgsz,
                                     classes_per_alphabet)
