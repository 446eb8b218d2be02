"""The Omniglot class banks and episode prior of the port against the JAX
package's, on the CPU.

As every port sampler, the synthetic bank and the episodes are
``draw(generator)`` plus a deterministic ``from_draws``; the tests feed
``from_draws`` with the JAX samplers' draws, replayed from their key trees
(``pfn_tpu/data/omniglot.py:107-140``, ``pfn_tpu/priors/omniglot.py``), and
compare with the JAX functions on the same key:

  * the synthetic bank: renders of the stroke prior, held to 1e-5 (cos, sin
    and square roots of f32 coordinates through the capsule cover, as the
    stroke prior's test holds them); the alphabet ids equal;
  * ``translate_image`` and whole episodes (classes, 90-degree rotations,
    instances, the support permutation, the query, the translations; also
    alphabet-grouped): exact. A JAX integer shift d in [lo, hi) is handed
    to the port as the uniform (d - lo + 1/2) / (hi - lo), which its
    lo + floor(u (hi - lo)) maps back to d;
  * the loader on PNG files written here, against the JAX loader: exact;
    its missing-directory error has the JAX message.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfn_tpu.data import omniglot as jdata
from pfn_tpu.priors import omniglot as jprior
from pfn_tpu.priors.stroke import StrokePrior as JaxStrokePrior
from pfn_tpu_torch.data import omniglot as tdata
from pfn_tpu_torch.models import PFNTransformer, TransformerConfig
from pfn_tpu_torch.priors import OmniglotPrior, omniglot_accuracy, translate_image

BANK_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: many small CPU ops, beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- the synthetic bank --------------------------------------------------------

def jax_bank_draws(seed: int, N: int, P: int, imgsz: int) -> dict:
    """The draws of pfn_tpu's synthetic_class_bank(seed, N, P, imgsz),
    replayed in the layout of the port's draw_synthetic_bank."""
    sp = JaxStrokePrior(num_features=imgsz * imgsz, num_outputs=1)
    size, S, K = sp.size, sp.min_max_strokes[1], sp.num_direction_candidates
    k_prog, k_render = jax.random.split(jax.random.PRNGKey(seed))
    ks = jax.random.split(k_prog, 5)
    lead = (N, 1, S)
    programs = {
        "num_strokes": jax.random.randint(ks[0], (N, 1), sp.min_max_strokes[0], S + 1)[:, 0],
        "starts": jax.random.randint(ks[1], lead + (K, 2), int(size * sp.min_max_start[0]),
                                     int(size * sp.min_max_start[1]) + 1).astype(jnp.float32)[:, 0],
        "lengths": jax.random.randint(ks[2], lead + (K,), int(size * sp.min_max_len[0]),
                                      int(size * sp.min_max_len[1]) + 1).astype(jnp.float32)[:, 0],
        "angles": (jax.random.uniform(ks[3], lead + (K,)) * (2 * math.pi))[:, 0],
    }
    off_max, tgt_max = int(size * sp.max_offset), int(size * sp.max_target_offset)

    def render_draws(rkey):
        k_w, k_off, k_jit, k_bright = jax.random.split(rkey, 4)
        return (jax.random.randint(k_w, (), int(size * sp.min_max_width[0]),
                                   int(size * sp.min_max_width[1]) + 1).astype(jnp.float32),
                jax.random.randint(k_off, (2,), -off_max, off_max + 1).astype(jnp.float32),
                jax.random.randint(k_jit, (S, 2), -tgt_max, tgt_max + 1).astype(jnp.float32),
                jax.random.uniform(k_bright, (size, size), minval=200.0 / 255.0, maxval=1.0))

    rkeys = jax.random.split(k_render, N * P).reshape(N, P, -1)
    drawn = jax.jit(jax.vmap(jax.vmap(render_draws)))(rkeys)
    renders = dict(zip(("width", "offset", "jitter", "brightness"), drawn))
    return {"programs": {k: _t(v) for k, v in programs.items()}, "renders": {k: _t(v) for k, v in renders.items()}}


def test_synthetic_bank_from_jax_draws():
    seed, N, P, imgsz, per_alphabet = 3, 6, 4, 12, 4
    want = jdata.synthetic_class_bank(seed=seed, num_classes=N, per_class=P, imgsz=imgsz,
                                      classes_per_alphabet=per_alphabet)
    got = tdata.synthetic_bank_from_draws(jax_bank_draws(seed, N, P, imgsz), imgsz, per_alphabet)
    assert got.images.shape == want.images.shape == (N, P, imgsz, imgsz) and got.images.dtype == torch.float32
    np.testing.assert_allclose(got.images.numpy(), want.images, atol=BANK_TOL, rtol=BANK_TOL)
    np.testing.assert_array_equal(got.alphabet_ids.numpy(), want.alphabet_ids)


def test_synthetic_bank_sampled_and_split():
    bank = tdata.synthetic_class_bank(seed=0, num_classes=12, per_class=5, imgsz=10, device="cpu")
    again = tdata.synthetic_class_bank(seed=0, num_classes=12, per_class=5, imgsz=10, device="cpu")
    assert torch.equal(bank.images, again.images)
    assert 0.0 <= float(bank.images.min()) and float(bank.images.max()) <= 1.01
    assert 0.02 < float((bank.images > 0).float().mean()) < 0.9
    # Instances of a class share its program: closer to each other than to other classes.
    flat = bank.images.reshape(12, 5, -1)
    within = (flat[:, 0] - flat[:, 1]).abs().mean()
    across = (flat[:, 0] - flat.roll(1, dims=0)[:, 1]).abs().mean()
    assert float(within) < float(across)
    train, test = bank.split(num_train_classes=8)
    assert (train.num_classes, test.num_classes) == (8, 4)
    with pytest.raises(ValueError, match="overlap"):
        bank.split(num_train_classes=8, test_start=6)
    with pytest.raises(ValueError, match="empty"):
        bank.split(num_train_classes=12)


def test_synthetic_bank_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdata.synthetic_class_bank(num_classes=2, per_class=2, imgsz=8)


# ---- translate_image -----------------------------------------------------------

def _margins(img: np.ndarray):
    """JAX's (lo, hi) shift ranges of an (H, W) image, rows then columns."""
    H, W = img.shape
    out = []
    for axis, n in ((0, H), (1, W)):
        has = (img > 1e-6).any(axis=1 - axis)
        first = int(np.argmax(has))
        last = n - 1 - int(np.argmax(has[::-1]))
        out.append((-first, n - last))
    return out


def jax_shift_uniforms(key, img: np.ndarray) -> np.ndarray:
    """The uniforms (2,) that make the port's translate_image shift ``img``
    as JAX's translate_image(key, img) does."""
    k_r, k_c = jax.random.split(key)
    u = []
    for k, (lo, hi) in zip((k_r, k_c), _margins(img)):
        d = int(jax.random.randint(k, (), lo, hi))
        u.append((d - lo + 0.5) / (hi - lo))
    return np.asarray(u, np.float32)


def test_translate_image_matches_jax():
    rng = np.random.default_rng(0)
    imgs = np.zeros((6, 14, 12), np.float32)
    for i, (r0, r1, c0, c1) in enumerate([(2, 6, 3, 9), (0, 14, 0, 12), (5, 7, 1, 2), (0, 3, 8, 12),
                                           (9, 14, 0, 4), (4, 5, 4, 5)]):
        imgs[i, r0:r1, c0:c1] = rng.uniform(0.1, 1.0, (r1 - r0, c1 - c0))
    imgs[5] = 0.0  # no ink: no shift
    keys = jax.random.split(jax.random.PRNGKey(4), len(imgs))
    want = np.stack([np.asarray(jprior.translate_image(k, jnp.asarray(im))) for k, im in zip(keys, imgs)])
    u = np.stack([jax_shift_uniforms(k, im) for k, im in zip(keys, imgs)])
    got = translate_image(torch.from_numpy(imgs), torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isclose(got.numpy().sum(axis=(1, 2)), imgs.sum(axis=(1, 2))).all()  # no ink leaves the canvas


# ---- episodes --------------------------------------------------------------------

def _episode_bank():
    rng = np.random.default_rng(1)
    images = np.zeros((9, 7, 10, 10), np.float32)
    for c in range(9):
        for p in range(7):
            r0, c0 = rng.integers(0, 5, 2)
            images[c, p, r0:r0 + 4, c0:c0 + 3] = rng.uniform(0.2, 1.0, (4, 3))
    return jdata.ClassBank(images, np.arange(9) // 3), tdata.ClassBank(torch.from_numpy(images),
                                                                      torch.arange(9) // 3)


def jax_episode_draws(prior: jprior.OmniglotPrior, key, B: int, T: int) -> dict:
    """The draws of pfn_tpu's OmniglotPrior.sample(key, B, T), replayed in
    the layout of the port's OmniglotPrior.draw."""
    C, P = prior.images.shape[:2]
    n_way = prior.num_outputs
    k_shot = (T - 1) // n_way
    untranslated = np.asarray(jprior.OmniglotPrior(prior.bank, n_way, translations=False,
                                                   rotation_class_augs=prior.rotation_class_augs,
                                                   alphabet_grouped=prior.alphabet_grouped).sample(key, B, T)[0])
    H = int(math.isqrt(untranslated.shape[-1]))
    d = {k: [] for k in ("classes", "alphabet", "class_noise", "rotations", "instances", "support_perm", "query",
                         "shift_u")}
    for b, k in enumerate(jax.random.split(key, B)):
        ks = jax.random.split(k, 6)
        if prior.alphabet_grouped:
            k_a, k_c = jax.random.split(ks[0])
            num_alphabets = int(np.max(prior.bank.alphabet_ids)) + 1
            d["alphabet"].append(jax.random.randint(k_a, (), 0, num_alphabets))
            d["class_noise"].append(jax.random.uniform(k_c, (C,)))
        else:
            d["classes"].append(jax.random.permutation(ks[0], C)[:n_way])
        d["rotations"].append(jax.random.randint(ks[1], (n_way,), 0, 4))
        d["instances"].append(jnp.stack([jax.random.permutation(kk, P)[: k_shot + 1]
                                         for kk in jax.random.split(ks[2], n_way)]))
        d["support_perm"].append(jax.random.permutation(ks[3], n_way * k_shot))
        d["query"].append(jax.random.randint(ks[4], (), 0, n_way))
        d["shift_u"].append(np.stack([jax_shift_uniforms(kt, untranslated[b, t].reshape(H, H))
                                      for t, kt in enumerate(jax.random.split(ks[5], T))]))
    return {k: _t(np.stack([np.asarray(a) for a in v])) for k, v in d.items() if v}


@pytest.mark.parametrize("grouped", [False, True], ids=["classes", "alphabet_grouped"])
def test_episodes_match_jax(grouped):
    jbank, bank = _episode_bank()
    B, T, n_way = 3, 11, 2  # 2-way 5-shot: an alphabet holds 3 classes
    jp = jprior.OmniglotPrior(jbank, num_outputs=n_way, alphabet_grouped=grouped)
    key = jax.random.PRNGKey(7)
    want_x, want_y, want_t = (np.asarray(a) for a in jax.jit(lambda k: jp.sample(k, B, T))(key))
    prior = OmniglotPrior(bank, num_outputs=n_way, alphabet_grouped=grouped)
    x, y, t = prior.from_draws(jax_episode_draws(jp, key, B, T))
    np.testing.assert_array_equal(x.numpy(), want_x)
    np.testing.assert_array_equal(y.numpy(), want_y)
    np.testing.assert_array_equal(t.numpy(), want_t)


def test_rotations_match_jnp_rot90():
    img = np.arange(12, dtype=np.float32).reshape(1, 3, 4)
    for k in range(4):
        np.testing.assert_array_equal(torch.rot90(torch.from_numpy(img), k, dims=(-2, -1)).numpy(),
                                      np.asarray(jnp.rot90(jnp.asarray(img), k, axes=(-2, -1))))


def test_episode_shapes_targets_and_query():
    _, bank = _episode_bank()
    n_way, k_shot = 3, 2
    T = n_way * k_shot + 1
    prior = OmniglotPrior(bank, num_outputs=n_way)
    x, y, t = prior.sample(16, T, generator=torch.Generator().manual_seed(0))
    assert x.shape == (16, T, 100) and y.shape == t.shape == (16, T)
    assert bool((t[:, :-1] == -100).all()) and torch.equal(t[:, -1], y[:, -1])
    for row in y:
        support, query = row[:-1], row[-1]
        assert sorted(support.tolist()) == sorted(list(range(n_way)) * k_shot)  # balanced
        assert query in support
    with pytest.raises(ValueError, match="divisible"):
        prior.sample(2, T + 1)
    with pytest.raises(ValueError, match="fewer than n_way"):
        OmniglotPrior(tdata.ClassBank(bank.images[:2], bank.alphabet_ids[:2]), num_outputs=3)


def test_alphabet_grouped_episodes_stay_in_one_alphabet():
    _, bank = _episode_bank()
    prior = OmniglotPrior(bank, num_outputs=3, alphabet_grouped=True)
    d = prior.draw(32, 7, generator=torch.Generator().manual_seed(2))
    cls = prior.episode_classes(d, bank.alphabet_ids)
    alph = bank.alphabet_ids[cls]
    assert bool((alph == d["alphabet"][:, None]).all())
    assert all(len(set(row.tolist())) == 3 for row in cls)


def test_untrained_accuracy_near_chance():
    _, bank = _episode_bank()
    prior = OmniglotPrior(bank, num_outputs=3)
    torch.manual_seed(0)
    model = PFNTransformer(TransformerConfig(num_features=100, n_out=3, emsize=16, nhead=2, nhid=32, nlayers=1))
    acc = omniglot_accuracy(model, prior, batch_size=64, seq_len=7, num_batches=4, seed=1)
    assert 0.2 < acc < 0.47  # chance 1/3 over 256 episodes


# ---- the loader -------------------------------------------------------------------

def _write_pngs(root):
    from PIL import Image

    rng = np.random.default_rng(3)
    for split, alphabets in (("images_background", ("Alpha", "Beta")), ("images_evaluation", ("Gamma",))):
        for alphabet in alphabets:
            for character in ("character01", "character02"):
                cdir = root / "omniglot-py" / split / alphabet / character
                cdir.mkdir(parents=True)
                for i in range(3):
                    Image.fromarray(rng.integers(0, 256, (20, 20)).astype(np.uint8)).save(cdir / f"{i:02d}.png")


def test_loader_matches_jax(tmp_path):
    _write_pngs(tmp_path)
    want = jdata.load_omniglot_class_bank(str(tmp_path), imgsz=8)
    got = tdata.load_omniglot_class_bank(str(tmp_path), imgsz=8)
    assert got.images.shape == (6, 3, 8, 8)
    np.testing.assert_array_equal(got.images.numpy(), want.images)
    np.testing.assert_array_equal(got.alphabet_ids.numpy(), want.alphabet_ids)


def test_loader_missing_directory(tmp_path):
    with pytest.raises(FileNotFoundError) as want:
        jdata.load_omniglot_class_bank(str(tmp_path / "nowhere"))
    with pytest.raises(FileNotFoundError) as got:
        tdata.load_omniglot_class_bank(str(tmp_path / "nowhere"))
    assert str(got.value) == str(want.value)
