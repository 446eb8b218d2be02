"""Parity of the port's model options with the JAX package's, on the CPU.

The same numpy inputs go through the flax module and its port, with the JAX
params carried over by the weight bridge (``state_dict_from_flax_params``,
loaded with ``strict=True``); emsize 32, 2 layers, f32. Tolerances: 1e-6
(atol and rtol) for a module alone, 1e-5 for the whole model (f32 summation
order through 2 layers, as tests/test_torch_port_model.py).

Covered: each positional encoding, encoder, decoder and SeqBN alone; the
model with each option on; ``exact_gelu`` through ``TrainConfig``;
dropout (identical to JAX in eval mode and at p = 0; in training the mask
rate at each of its three sites within 4 sigma of p, the scale 1 / (1 - p),
and the masks a function of the generator's state); the paired-scrambled
encoding (unscrambled when deterministic, ValueError in training with
dropout); ``fused_supported`` rejecting each option with the JAX package's
reason; and every encoder and positional-encoding registry entry against
the JAX entry of the same name.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfn_tpu import registries as jreg
from pfn_tpu.models import decoders as jdec
from pfn_tpu.models import fused_apply as jfused
from pfn_tpu.models import transformer as jtr
from pfn_tpu.train.loop import TrainConfig as JaxTrainConfig
from pfn_tpu_torch import registries
from pfn_tpu_torch.models import (
    FixedScaledDecoder,
    PFNTransformer,
    ScaledDecoder,
    SeqBN,
    TransformerConfig,
    fused_apply,
)
from pfn_tpu_torch.models import transformer as ttr
from pfn_tpu_torch.models.positional import PairedScrambledPositionalEncodings
from pfn_tpu_torch.priors import RidgePrior
from pfn_tpu_torch.train import (
    TrainConfig,
    build_model,
    mse_criterion,
    seeded_flax_params,
    state_dict_from_flax_params,
    train,
)

MODULE_TOL, MODEL_TOL = 1e-6, 1e-5
NFEAT, NOUT, EMSIZE, NHEAD, NHID, NLAYERS, MAX_LEN = 3, 10, 32, 2, 64, 2, 64
B, T, SEP = 2, 24, 9
DECODERS = {"scaled": (jdec.ScaledDecoder, ScaledDecoder), "fixed_scaled": (jdec.FixedScaledDecoder,
                                                                          FixedScaledDecoder)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: many small CPU ops, beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((B, T, NFEAT)).astype(np.float32), rng.standard_normal((B, T)).astype(np.float32)


def _submodule_state(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _tree(seed=0, **options):
    return seeded_flax_params(NFEAT, EMSIZE, NHID, NLAYERS, NOUT, seed=seed, max_len=MAX_LEN, **options)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), atol=tol, rtol=tol)


# ---- modules alone ---------------------------------------------------------


@pytest.mark.parametrize("name", ["sinus", "learned", "paired_scrambled_learned"])
def test_positional_encoding_alone(name):
    tree = _tree(seed=1, pos_encoder=name)["params"]
    x = np.random.default_rng(2).standard_normal((B, T, EMSIZE)).astype(np.float32)
    jmod = jreg.POS_ENCODERS.get(name)(max_len=MAX_LEN)
    jparams = {"params": tree["pos_encoder"]} if "pos_encoder" in tree else {}
    want = jmod.apply(jparams, jnp.asarray(x), deterministic=True)
    mod = registries.POS_ENCODERS.get(name)(EMSIZE, max_len=MAX_LEN)
    mod.load_state_dict(_submodule_state(state_dict_from_flax_params(tree, NLAYERS), "pos_encoder."), strict=True)
    _close(mod(torch.from_numpy(x), deterministic=True).detach(), want, MODULE_TOL)


@pytest.mark.parametrize("name", ["linear", "normalized_uniform", "mlp"])
def test_encoder_alone(name):
    tree = _tree(seed=3, encoder=name)["params"]
    x, _ = _inputs(seed=4)
    want = jreg.ENCODERS.get(name)(EMSIZE).apply({"params": tree["encoder"]}, jnp.asarray(x))
    mod = registries.ENCODERS.get(name)(NFEAT, EMSIZE)
    mod.load_state_dict(_submodule_state(state_dict_from_flax_params(tree, NLAYERS), "encoder."), strict=True)
    _close(mod(torch.from_numpy(x)).detach(), want, MODULE_TOL)


@pytest.mark.parametrize("name", ["canonical", "embedding"])
def test_embedding_encoder_alone(name):
    """The JAX constructors (num_features, num_classes, emsize) and
    (num_features, emsize, num_embs): integer features below 5 classes, and
    features in [0, 1] with values outside it, which clip to the end bins."""
    classes = 5
    rng = np.random.default_rng(6)
    if name == "canonical":
        x = rng.integers(0, classes, (B, T, NFEAT)).astype(np.float32)
        jmod, args = jreg.ENCODERS.get(name)(NFEAT, classes, EMSIZE + 1), (NFEAT, classes, EMSIZE + 1)
    else:
        x = rng.uniform(-0.2, 1.2, (B, T, NFEAT)).astype(np.float32)
        jmod, args = jreg.ENCODERS.get(name)(NFEAT, EMSIZE + 1, 7), (NFEAT, EMSIZE + 1, 7)
    # emsize must divide over the features: 33 = 3 x 11.
    tree = seeded_flax_params(NFEAT, EMSIZE + 1, NHID, 0, NOUT, seed=5, encoder=name, num_classes=classes,
                              num_embs=7)["params"]
    want = jmod.apply({"params": tree["encoder"]}, jnp.asarray(x))
    mod = registries.ENCODERS.get(name)(*args)
    mod.load_state_dict(_submodule_state(state_dict_from_flax_params(tree, 0), "encoder."), strict=True)
    _close(mod(torch.from_numpy(x)).detach(), want, MODULE_TOL)


@pytest.mark.parametrize("name", list(DECODERS))
def test_decoder_alone(name):
    tree = _tree(seed=7, decoder=name)["params"]
    x = np.random.default_rng(8).standard_normal((B, T, EMSIZE)).astype(np.float32)
    jcls, cls = DECODERS[name]
    want = jcls(NHID, NOUT).apply({"params": tree["decoder"]}, jnp.asarray(x))
    mod = cls(EMSIZE, NHID, NOUT)
    mod.load_state_dict(_submodule_state(state_dict_from_flax_params(tree, NLAYERS), "decoder."), strict=True)
    _close(mod(torch.from_numpy(x)).detach(), want, MODULE_TOL)


def test_seqbn_alone():
    """Batch statistics over (B*T, D), biased variance, eps 1e-5, the same in
    train and eval mode (no running averages)."""
    tree = _tree(seed=9, input_normalization=True)["params"]
    x = (3.0 + 2.0 * np.random.default_rng(10).standard_normal((B, T, EMSIZE))).astype(np.float32)
    want = jtr.SeqBN().apply({"params": tree["input_ln"]}, jnp.asarray(x))
    mod = SeqBN(EMSIZE)
    mod.load_state_dict(_submodule_state(state_dict_from_flax_params(tree, NLAYERS), "input_ln."), strict=True)
    _close(mod.train()(torch.from_numpy(x)).detach(), want, MODULE_TOL)
    _close(mod.eval()(torch.from_numpy(x)).detach(), want, MODULE_TOL)


def test_registry_entries_are_the_jax_entries():
    """Every encoder and positional-encoding entry is the port of the JAX
    entry of the same name; the behaviour of each is held above."""
    for jtable, table in ((jreg.ENCODERS, registries.ENCODERS), (jreg.POS_ENCODERS, registries.POS_ENCODERS)):
        assert table.names() == jtable.names()
        for name in table.names():
            assert table.get(name).__name__ == jtable.get(name).__name__, name


def test_canonical_and_embedding_are_not_built_from_the_registry_by_jax():
    """The JAX model builds an encoder as factory(emsize), which leaves the
    required fields of CanonicalEmbedding and EmbeddingEncoder unset: a
    TypeError, so no JAX config trains them through the registry. The port
    adds no wrapper: CanonicalEmbedding fails the same way under the port's
    factory(in_features, emsize); EmbeddingEncoder(num_features, emsize,
    num_embs=100) builds, since its first two fields are what the port's
    protocol passes (a consequence of the protocol, not a feature)."""
    for name in ("canonical", "embedding"):
        cfg = jtr.TransformerConfig(num_features=NFEAT, n_out=NOUT, emsize=EMSIZE + 1, nhead=3, nhid=NHID,
                                    nlayers=1, encoder=jreg.ENCODERS.get(name), attention_impl="dense")
        with pytest.raises(TypeError):
            jtr.PFNTransformer(cfg).init_params(jax.random.PRNGKey(0))
    base = TransformerConfig(num_features=NFEAT, n_out=NOUT, emsize=EMSIZE + 1, nhead=3, nhid=NHID, nlayers=1)
    with pytest.raises(TypeError):
        PFNTransformer(dataclasses.replace(base, encoder=registries.ENCODERS.get("canonical")))
    model = PFNTransformer(dataclasses.replace(base, encoder=registries.ENCODERS.get("embedding"))).eval()
    x, y = _inputs(seed=11)
    assert bool(torch.isfinite(model(torch.from_numpy(x), torch.from_numpy(y), SEP)).all())


# ---- the whole model ---------------------------------------------------------

OPTIONS = {
    "normalized_uniform_encoder": dict(encoder="normalized_uniform"),
    "mlp_encoder": dict(encoder="mlp"),
    "mlp_y_encoder": dict(y_encoder="mlp"),
    "seqbn": dict(input_normalization=True),
    "sinus": dict(pos_encoder="sinus"),
    "learned": dict(pos_encoder="learned"),
    "paired_scrambled_learned": dict(pos_encoder="paired_scrambled_learned"),
    "scaled_decoder": dict(decoder="scaled"),
    "fixed_scaled_decoder": dict(decoder="fixed_scaled"),
    "dropout_eval": dict(dropout=0.1),
    "all": dict(encoder="normalized_uniform", y_encoder="mlp", input_normalization=True, pos_encoder="learned",
                decoder="scaled", dropout=0.1),
}


def _configs(options: dict, exact_gelu=False):
    """The JAX and port TransformerConfigs, and the seeded tree's options."""
    common = dict(num_features=NFEAT, n_out=NOUT, emsize=EMSIZE, nhead=NHEAD, nhid=NHID, nlayers=NLAYERS,
                  attention_impl="dense", max_len=MAX_LEN, exact_gelu=exact_gelu,
                  dropout=options.get("dropout", 0.0), input_normalization=options.get("input_normalization", False))
    jkw, kw, tree = {}, {}, {"input_normalization": common["input_normalization"]}
    for field in ("encoder", "y_encoder"):
        if field in options:
            jkw[field], kw[field] = jreg.ENCODERS.get(options[field]), registries.ENCODERS.get(options[field])
            tree[field] = options[field]
    if "pos_encoder" in options:
        name = options["pos_encoder"]
        jkw["pos_encoder"], kw["pos_encoder"] = jreg.POS_ENCODERS.get(name), registries.POS_ENCODERS.get(name)
        tree["pos_encoder"] = name
    if "decoder" in options:
        jkw["decoder"], kw["decoder"] = DECODERS[options["decoder"]]
        tree["decoder"] = options["decoder"]
    return jtr.TransformerConfig(**common, **jkw), TransformerConfig(**common, **kw), tree


def _jax_logits(jcfg, tree, x, y):
    params = {"params": {k: v for k, v in tree["params"].items()}}
    return np.asarray(jtr.PFNTransformer(jcfg).apply(params, jnp.asarray(x), jnp.asarray(y), SEP))


def _port_model(cfg, tree):
    model = PFNTransformer(cfg)
    model.load_state_dict(state_dict_from_flax_params(tree, NLAYERS), strict=True)
    return model


@pytest.mark.parametrize("option", list(OPTIONS))
def test_model_with_option_matches_jax(option):
    jcfg, cfg, tree_opts = _configs(OPTIONS[option])
    tree = _tree(seed=12, **tree_opts)
    x, y = _inputs(seed=13)
    want = _jax_logits(jcfg, tree, x, y)
    with torch.no_grad():
        got = _port_model(cfg, tree).eval()(torch.from_numpy(x), torch.from_numpy(y), SEP)
    _close(got, want, MODEL_TOL)


def test_exact_gelu_reaches_the_model_through_train_config():
    """A deviation, named: the JAX TrainConfig has no exact_gelu field (so the
    JAX loop builds a tanh-GELU model from an exact-GELU checkpoint); the
    port's does, and build_model passes it into TransformerConfig, whose
    exact GELU the port computes as the JAX model does."""
    assert "exact_gelu" not in {f.name for f in dataclasses.fields(JaxTrainConfig)}
    prior = RidgePrior(num_features=NFEAT)
    crit = mse_criterion()
    tcfg = TrainConfig(emsize=EMSIZE, nhid=NHID, nlayers=NLAYERS, nhead=NHEAD, bptt=T, device="cpu",
                       exact_gelu=True, attention_impl="dense")
    model = build_model(prior, crit, tcfg)
    assert model.config.exact_gelu
    assert model.decoder[1].approximate == "none"
    assert all(layer.gelu_approximate == "none" for layer in model.transformer_encoder.layers)
    tree = seeded_flax_params(NFEAT, EMSIZE, NHID, NLAYERS, 1, seed=14)
    model.load_state_dict(state_dict_from_flax_params(tree, NLAYERS), strict=True)
    jcfg = jtr.TransformerConfig(num_features=NFEAT, n_out=1, emsize=EMSIZE, nhead=NHEAD, nhid=NHID,
                                 nlayers=NLAYERS, attention_impl="dense", max_len=max(T * 2, 16), exact_gelu=True)
    x, y = _inputs(seed=15)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x), torch.from_numpy(y), SEP)
    _close(got, _jax_logits(jcfg, tree, x, y), MODEL_TOL)
    assert not build_model(prior, crit, dataclasses.replace(tcfg, exact_gelu=False)).config.exact_gelu


# ---- dropout -------------------------------------------------------------------


def test_dropout_zero_in_training_matches_jax():
    """p = 0 is deterministic in training too, as the JAX loop's
    deterministic = (dropout == 0)."""
    jcfg, cfg, tree_opts = _configs({"input_normalization": True, "pos_encoder": "learned"})
    tree = _tree(seed=16, **tree_opts)
    x, y = _inputs(seed=17)
    with torch.no_grad():
        got = _port_model(cfg, tree).train()(torch.from_numpy(x), torch.from_numpy(y), SEP)
    _close(got, _jax_logits(jcfg, tree, x, y), MODEL_TOL)


def test_dropout_sites_rate_and_scale(monkeypatch):
    """In training at p = 0.25 the layer drops at the JAX layer's three sites
    (after out_proj, after the FFN's GELU, after linear2), in that order in
    every layer: the dropped share of each site within 4 sigma of p, every
    kept entry scaled by exactly 1 / (1 - p)."""
    p = 0.25
    calls = []
    real = ttr.dropout

    def recording(x, rate, generator):
        out = real(x, rate, generator)
        calls.append((x.detach().clone(), out.detach().clone(), rate))
        return out

    monkeypatch.setattr(ttr, "dropout", recording)
    _, cfg, _ = _configs({"dropout": p})
    tree = _tree(seed=18)
    x, y = _inputs(seed=19)
    _port_model(cfg, tree).train()(torch.from_numpy(x), torch.from_numpy(y), SEP,
                                   generator=torch.Generator().manual_seed(0))
    assert len(calls) == 3 * NLAYERS
    widths = [EMSIZE, NHID, EMSIZE] * NLAYERS
    for (inp, out, rate), width in zip(calls, widths):
        assert rate == p and inp.shape == (B, T, width)
        live = inp != 0
        dropped = (out == 0) & live
        share = float(dropped.sum()) / float(live.sum())
        sigma = (p * (1 - p) / float(live.sum())) ** 0.5
        assert abs(share - p) <= 4 * sigma, (share, sigma)
        kept = live & ~dropped
        torch.testing.assert_close(out[kept], inp[kept] / (1 - p), atol=0, rtol=0)


def test_dropout_masks_follow_the_generator_state():
    _, cfg, _ = _configs({"dropout": 0.1})
    model = _port_model(cfg, _tree(seed=20)).train()
    x, y = (torch.from_numpy(a) for a in _inputs(seed=21))

    def run(seed):
        with torch.no_grad():
            return model(x, y, SEP, generator=torch.Generator().manual_seed(seed))

    dropped = run(3)
    torch.testing.assert_close(run(3), dropped, atol=0, rtol=0)
    assert not torch.equal(run(4), dropped)
    with torch.no_grad():
        assert not torch.equal(model.eval()(x, y, SEP), dropped)


def test_scrambled_encoding_is_unscrambled_when_deterministic_and_refuses_dropout():
    """The JAX module permutes its pairs only when not deterministic, which
    the JAX loop never reaches (it raises for the missing 'scramble' stream
    with dropout > 0: an inherited defect, ROADMAP.md queue 3). The port adds
    its table as it is when deterministic and raises ValueError in training
    with dropout, naming the defect."""
    with pytest.raises(ValueError, match="even max_len"):
        PairedScrambledPositionalEncodings(EMSIZE, max_len=63)
    _, learned_cfg, _ = _configs({"pos_encoder": "learned"})
    _, cfg, tree_opts = _configs({"pos_encoder": "paired_scrambled_learned"})
    tree = _tree(seed=22, **tree_opts)
    x, y = (torch.from_numpy(a) for a in _inputs(seed=23))
    with torch.no_grad():
        want = _port_model(learned_cfg, tree).eval()(x, y, SEP)
        torch.testing.assert_close(_port_model(cfg, tree).eval()(x, y, SEP), want, atol=0, rtol=0)
        torch.testing.assert_close(_port_model(cfg, tree).train()(x, y, SEP), want, atol=0, rtol=0)
    dropped = _port_model(dataclasses.replace(cfg, dropout=0.1), tree).train()
    with pytest.raises(ValueError, match="scramble"):
        dropped(x, y, SEP, generator=torch.Generator().manual_seed(0))


# ---- the fused path ------------------------------------------------------------


@pytest.mark.parametrize("option", [o for o in OPTIONS if o != "all"] + ["exact_gelu"])
def test_fused_supported_rejects_each_option_with_the_jax_reason(option):
    jcfg, cfg, _ = _configs(OPTIONS.get(option, {}), exact_gelu=option == "exact_gelu")
    want = jfused.fused_supported(jcfg)
    assert want is not None
    assert fused_apply.fused_supported(cfg) == want
    assert fused_apply.fused_supported(cfg, "cuda") == want


def test_train_draws_the_masks_from_its_own_generator(monkeypatch):
    """train() hands every forward one generator, its training generator,
    whose state moves on between forwards (the prior, sep and the masks all
    draw from it), so no two microbatches share their masks and a resume
    restores the stream."""
    seen = []
    real = PFNTransformer.forward

    def recording(self, x, y, sep, generator=None):
        seen.append((generator, None if generator is None else generator.get_state()))
        return real(self, x, y, sep, generator=generator)

    monkeypatch.setattr(PFNTransformer, "forward", recording)
    cfg = TrainConfig(emsize=EMSIZE, nhid=NHID, nlayers=1, nhead=NHEAD, bptt=12, batch_size=2, epochs=1,
                      steps_per_epoch=4, aggregate_k_gradients=2, dropout=0.1, lr=1e-3, device="cpu", verbose=False)
    train(RidgePrior(num_features=NFEAT), mse_criterion(), cfg)
    assert len(seen) == 4 and all(g is seen[0][0] for g, _ in seen) and seen[0][0] is not None
    states = [s for _, s in seen]
    assert all(not torch.equal(a, b) for i, a in enumerate(states) for b in states[i + 1:])
