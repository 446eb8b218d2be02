"""Omniglot few-shot episodes as a PFN prior.

Port of ``pfn_tpu/priors/omniglot.py`` (reference priors/omniglot.py and
datasets/omniglotNshot.py):
  * an episode is an N-way k-shot support set plus one query at the end;
    targets are -100 everywhere but the last position (priors/omniglot.py:
    60-70);
  * the support (omniglotNshot.py:185-212): n_way distinct classes, k_shot
    + 1 distinct instances of each, an optional random 90-degree rotation per
    class (omniglotNshot.py:196-199), the support shuffled; the query is one
    more instance of a uniformly drawn class among the n_way;
  * each image is shifted by a random offset bounded by its content's
    bounding box, so no ink leaves the canvas (translate_omniglot,
    priors/omniglot.py:12-35);
  * ``alphabet_grouped``: the classes of an episode from one random alphabet
    (OmniglotNShotJonas, omniglotNshot.py:16-77);
  * :func:`omniglot_accuracy`: last-position accuracy on held-out-class
    episodes (priors/omniglot.py:74-98).

The bank lives on the device as one tensor (the prior keeps a copy per
device it is asked for), and a batch of episodes is built there in one
batched pass, with no host loop per episode. As every port sampler, it is
:meth:`OmniglotPrior.draw` (every random number, from a ``torch.Generator``)
and the deterministic :meth:`OmniglotPrior.from_draws`, which the tests feed
with the JAX prior's replayed draws:
  * classes: the first n_way of a random permutation (a draw), or with
    alphabet grouping a random alphabet and uniform noise, ranked by
    ``argsort(not member + noise / 2)`` (stable, as ``jnp.argsort``);
  * the translation of each image is a uniform u in [0, 1) per axis, mapped
    to lo + floor(u (hi - lo)) in the integer range [lo, hi) that its content
    allows (``jax.random.randint``'s range), as :func:`translate_image`.
"""

from __future__ import annotations

import dataclasses

import torch

from pfn_tpu_torch.data.omniglot import ClassBank


def _content_first_last(has: torch.Tensor):
    """(first, last) index along the last axis where ``has`` is True; (0,
    n-1) where it never is (``jnp.argmax`` of all False is 0)."""
    n = has.shape[-1]
    h = has.to(torch.int32)
    first = torch.argmax(h, dim=-1)
    last = n - 1 - torch.argmax(h.flip(-1), dim=-1)
    return first, last


def translation_ranges(img: torch.Tensor):
    """The shift ranges [lo, hi) of each image (..., H, W) that keep its ink
    on the canvas, rows then columns: (lo (..., 2), hi (..., 2)) int64
    (translate_omniglot's margins: lo = -first, hi = size - last)."""
    H, W = img.shape[-2:]
    ink = img > 1e-6
    r0, r1 = _content_first_last(ink.any(dim=-1))
    c0, c1 = _content_first_last(ink.any(dim=-2))
    lo = torch.stack([-r0, -c0], dim=-1)
    hi = torch.stack([H - r1, W - c1], dim=-1)
    return lo, hi


def translate_image(img: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Shift each image (..., H, W) by an in-bounds offset: per axis lo +
    floor(u (hi - lo)) (``u`` (..., 2) uniforms in [0, 1)), rolled with
    wrap-around, which is exact because the shift never exceeds the empty
    margin (``jnp.roll`` in the JAX prior)."""
    H, W = img.shape[-2:]
    lo, hi = translation_ranges(img)
    span = hi - lo
    shift = lo + torch.minimum(torch.floor(u * span).to(torch.int64), span - 1)  # (..., 2)
    rows = (torch.arange(H, device=img.device) - shift[..., 0:1]) % H  # (..., H): source row of each row
    cols = (torch.arange(W, device=img.device) - shift[..., 1:2]) % W
    out = torch.gather(img, -2, rows[..., :, None].expand(img.shape))
    return torch.gather(out, -1, cols[..., None, :].expand(img.shape))


@dataclasses.dataclass
class OmniglotPrior:
    """N-way k-shot episodes over a :class:`ClassBank`.

    ``seq_len`` must satisfy (seq_len - 1) % num_outputs == 0
    (priors/omniglot.py:45); then k_shot = (seq_len - 1) // num_outputs.
    """

    bank: ClassBank
    num_outputs: int = 5  # n_way
    translations: bool = True
    rotation_class_augs: bool = True
    alphabet_grouped: bool = False

    def __post_init__(self):
        C, P, H, W = self.bank.images.shape
        if C < self.num_outputs:
            raise ValueError(f"the bank has {C} classes, fewer than n_way = {self.num_outputs}")
        self.num_features = H * W
        self.num_alphabets = int(self.bank.alphabet_ids.max()) + 1
        self._banks = {self.bank.images.device: self.bank}

    def _bank_on(self, device) -> ClassBank:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in self._banks:
            self._banks[device] = self.bank.to(device)
        return self._banks[device]

    def _check_seq_len(self, seq_len: int) -> int:
        if (seq_len - 1) % self.num_outputs:
            raise ValueError("seq_len - 1 must be divisible by n_way")  # reference priors/omniglot.py:45
        return (seq_len - 1) // self.num_outputs

    def draw(self, batch_size: int, seq_len: int, generator: torch.Generator | None = None, device=None) -> dict:
        """Every random draw of B episodes, on ``device``:

        * ``classes`` (B, n_way), distinct; or, with ``alphabet_grouped``,
          ``alphabet`` (B,) and ``class_noise`` (B, C) uniforms;
        * ``rotations`` (B, n_way) in 0..3 (with ``rotation_class_augs``);
        * ``instances`` (B, n_way, k_shot + 1), distinct per class;
        * ``support_perm`` (B, n_way k_shot), a permutation;
        * ``query`` (B,) in 0..n_way-1;
        * ``shift_u`` (B, T, 2) uniforms (with ``translations``).
        """
        C, P = self.bank.images.shape[:2]
        n_way, B = self.num_outputs, batch_size
        k_shot = self._check_seq_len(seq_len)

        def rand(*shape):
            return torch.rand(shape, generator=generator, device=device)

        d = {}
        if self.alphabet_grouped:
            d["alphabet"] = torch.randint(0, self.num_alphabets, (B,), generator=generator, device=device)
            d["class_noise"] = rand(B, C)
        else:
            d["classes"] = torch.argsort(rand(B, C), dim=-1)[:, :n_way]
        if self.rotation_class_augs:
            d["rotations"] = torch.randint(0, 4, (B, n_way), generator=generator, device=device)
        d["instances"] = torch.argsort(rand(B, n_way, P), dim=-1)[..., : k_shot + 1]
        d["support_perm"] = torch.argsort(rand(B, n_way * k_shot), dim=-1)
        d["query"] = torch.randint(0, n_way, (B,), generator=generator, device=device)
        if self.translations:
            d["shift_u"] = rand(B, seq_len, 2)
        return d

    def episode_classes(self, d: dict, alphabet_ids: torch.Tensor) -> torch.Tensor:
        """The n_way classes of each episode (B, n_way): ``d["classes"]``, or
        with alphabet grouping the first n_way of argsort(not member + noise /
        2), the members of the drawn alphabet first (OmniglotNShotJonas.next,
        omniglotNshot.py:38-48; an alphabet has at least n_way classes)."""
        if not self.alphabet_grouped:
            return d["classes"]
        member = alphabet_ids[None, :] == d["alphabet"][:, None]  # (B, C)
        scores = torch.where(member, 0.0, 1.0) + d["class_noise"] * 0.5
        return torch.argsort(scores, dim=-1, stable=True)[:, : self.num_outputs]

    def from_draws(self, d: dict):
        """(x (B, T, H W), y (B, T), target (B, T)) f32 of :meth:`draw`'s
        draws, on their device."""
        device = d["instances"].device
        bank = self._bank_on(device)
        C, P, H, W = bank.images.shape
        n_way = self.num_outputs
        inst = d["instances"]  # (B, n_way, k+1)
        B, k_shot = inst.shape[0], inst.shape[-1] - 1
        T = n_way * k_shot + 1

        cls = self.episode_classes(d, bank.alphabet_ids)  # (B, n_way)
        picked = bank.images[cls[..., None], inst]  # (B, n_way, k+1, H, W)
        if self.rotation_class_augs:
            rots = torch.stack([torch.rot90(picked, r, dims=(-2, -1)) for r in range(4)])  # (4, B, n_way, ...)
            b, c = torch.arange(B, device=device)[:, None], torch.arange(n_way, device=device)[None, :]
            picked = rots[d["rotations"], b, c]

        support = picked[:, :, :k_shot].reshape(B, n_way * k_shot, H, W)
        support_y = torch.arange(n_way, device=device).repeat_interleave(k_shot).expand(B, -1)
        perm = d["support_perm"]
        support = torch.gather(support, 1, perm[:, :, None, None].expand(-1, -1, H, W))
        support_y = torch.gather(support_y, 1, perm)

        q = d["query"]
        query = picked[torch.arange(B, device=device), q, k_shot]  # (B, H, W)
        x = torch.cat([support, query[:, None]], dim=1)  # (B, T, H, W)
        y = torch.cat([support_y, q[:, None]], dim=1)
        if self.translations:
            x = translate_image(x, d["shift_u"])
        target = torch.full((B, T), -100, dtype=torch.int64, device=device)
        target[:, -1] = q
        return x.reshape(B, T, H * W), y.float(), target.float()

    def sample(self, batch_size: int, seq_len: int, generator: torch.Generator | None = None, device=None):
        """(x (B, T, H W), y (B, T), target_y (B, T)) on ``device`` (None:
        the bank's)."""
        device = self.bank.images.device if device is None else device
        return self.from_draws(self.draw(batch_size, seq_len, generator, device))


@torch.no_grad()
def omniglot_accuracy(model, prior: OmniglotPrior, batch_size: int = 32, seq_len: int = 26, num_batches: int = 4,
                      seed: int = 0) -> float:
    """Last-position episode accuracy, the reference's validate hook
    (priors/omniglot.py:74-98): ``num_batches`` batches of episodes of
    ``prior`` (built on the test split of a bank), drawn on the model's
    device from a generator seeded with ``seed``, each one forward with
    single_eval_pos = seq_len - 1. One host sync, at the end."""
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    was_training = model.training
    model.eval()
    hits = torch.zeros((), dtype=torch.int64, device=device)
    for _ in range(num_batches):
        x, y, _ = prior.sample(batch_size, seq_len, generator=generator, device=device)
        logits = model(x, y, seq_len - 1)
        pred = torch.argmax(logits[:, -1, : prior.num_outputs], dim=-1)
        hits += (pred == y[:, -1].to(torch.int64)).sum()
    model.train(was_training)
    return int(hits) / (batch_size * num_batches)
