"""The port's optimizers against the JAX package's.

Same numpy params, gradients and state go to ``repro.optim`` and
``repro_torch.optim``; each comparison is one update from the same inputs
(the port gets the reference's state before every step).  Tolerances:

  * updates and float32 state: 1e-6 relative (max|Δ| / max|ref|), float32
    elementwise math; XLA:CPU contracts ``b·m + c·g`` into one FMA where
    torch rounds twice, and its ``rsqrt`` and means differ by ulps.
  * bfloat16 moments: bit for bit, except where the port's float32 moment
    lies within the float32 tolerance (1e-6 of the leaf's largest moment)
    of a bfloat16 rounding boundary: there the last f32 ulps decide the
    rounding, and the two may differ by one bfloat16 ulp.  The cast itself
    equals XLA's ``astype`` bit for bit on every f32 pattern tried (ties to
    even included).
  * Adafactor over a model: the state has the JAX tree's paths and shapes
    leaf for leaf (its statistics are over stacked block leaves), reduced
    smollm-135m and reduced zamba2-7b (a mamba run of 2: its 1-D leaves are
    factored over (run_len, d), and the RMS spans the run's layers).
  * several whole steps, a jitted ``repro.train.make_train_step`` against
    the port's from the same weights and batches: losses 1e-4 relative;
    weights within a tenth of the steps' total lr (absolute), the rule of
    tests/test_torch_train.py.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.data import make_task as j_make_task
from repro.models import lm_init as j_lm_init
from repro.optim import optimizers as jo
from repro.optim import cosine_warmup as j_cosine_warmup
from repro.train import make_train_step as j_make_train_step
from repro.train import train_state_init as j_train_state_init
from repro_torch.checkpoint import to_jax_layout_state
from repro_torch.configs import get_reduced
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.optim import (
    AdafactorState,
    FactoredV,
    adafactor,
    adamw,
    cosine_warmup,
    make_optimizer,
    sgdm,
)
from repro_torch.train import TrainState, make_train_step
from repro_torch.tree import tree_items, tree_unflatten


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops on one thread in this module: the suite runs several
    workers side by side, and each worker's default intra-op pool (one
    thread per core) oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-6
BF16 = torch.bfloat16
SHAPES = {"a": (3, 4), "b": {"c": (5,), "d": (2, 3, 4), "e": (4, 1)}, "s": ()}

# (name, reference kwargs, port kwargs): every moment dtype and momentum
CASES = [
    ("adamw_f32", "adamw", {}, {}),
    ("adamw_bf16", "adamw", {"state_dtype": jnp.bfloat16}, {"state_dtype": BF16}),
    ("adafactor", "adafactor", {}, {}),
    ("adafactor_wd", "adafactor", {"weight_decay": 0.1}, {"weight_decay": 0.1}),
    ("adafactor_nomom", "adafactor", {"momentum": None}, {"momentum": None}),
    ("adafactor_nomom_wd", "adafactor", {"momentum": None, "weight_decay": 0.1},
     {"momentum": None, "weight_decay": 0.1}),
    ("sgdm", "sgdm", {}, {}),
    ("sgdm_wd_bf16", "sgdm", {"weight_decay": 0.1, "state_dtype": jnp.bfloat16},
     {"weight_decay": 0.1, "state_dtype": BF16}),
]


def to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(BF16)
    return torch.from_numpy(np.array(a, copy=True))


def to_np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == BF16:
        return t.float().numpy()
    return t.detach().numpy()


def flat(tree):
    """{keystr path: numpy} of a JAX tree."""
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def from_ref(template, jtree):
    """The port tree shaped like ``template`` holding the JAX tree's leaves
    at the same paths (the two packages' key format is one)."""
    ref = flat(jtree)
    return tree_unflatten(template, [to_torch(ref[key]) for key, _ in tree_items(template)])


def rel(port, ref) -> float:
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def near_bf16_boundary(x32: np.ndarray) -> np.ndarray:
    """Where a float32 value within the float32 tolerance of ``x32`` (TOL
    times the leaf's largest magnitude, the ``rel`` metric) rounds to
    another bfloat16."""
    w = TOL * np.abs(x32).max()
    lo = (x32 - w).astype(ml_dtypes.bfloat16)
    hi = (x32 + w).astype(ml_dtypes.bfloat16)
    return lo.view(np.uint16) != hi.view(np.uint16)


def assert_bf16_moment(port_bf16, ref_bf16, port_f32, key):
    """Bit for bit except within 1e-6 of a rounding boundary (docstring)."""
    got = port_bf16.view(torch.int16).numpy().view(np.uint16)
    want = np.asarray(ref_bf16).view(np.uint16)
    near = near_bf16_boundary(port_f32.numpy())
    assert ((got == want) | near).all(), (key, int(((got != want) & ~near).sum()))
    # and there the two roundings of values within that tolerance: apart by
    # at most the tolerance plus one bfloat16 ulp
    gotf, wantf = got.view(ml_dtypes.bfloat16).astype(np.float32), np.asarray(
        ref_bf16).astype(np.float32)
    bound = TOL * np.abs(port_f32.numpy()).max() + 2.0**-7 * np.maximum(abs(gotf), abs(wantf))
    assert (np.abs(gotf - wantf) <= bound).all(), key


def assert_states(port_state, ref_state, f32_state, key_prefix=""):
    """Every leaf of the port's state against the reference's at its path:
    float32 at TOL, bfloat16 by ``assert_bf16_moment`` against the port's
    float32 moment (``f32_state``, the same update with float32 moments)."""
    ref = flat(ref_state)
    f32 = dict(tree_items(f32_state))
    items = list(tree_items(port_state))
    assert {k for k, _ in items} == set(ref), set(ref) ^ {k for k, _ in items}
    for key, t in items:
        assert tuple(t.shape) == ref[key].shape, (key, t.shape, ref[key].shape)
        if t.dtype == BF16:
            assert_bf16_moment(t, ref[key], f32[key], key_prefix + key)
        elif t.dtype == torch.int32:
            assert int(t) == int(ref[key]), key
        else:
            assert rel(to_np(t), ref[key]) < TOL, (key_prefix + key, rel(to_np(t), ref[key]))


def f32_twin(name, kw):
    """The same optimizer with float32 moments (the port's unrounded ones)."""
    key = "momentum_dtype" if name == "adafactor" else "state_dtype"
    return dict(kw, **{key: torch.float32})


def upcast(state):
    return tree_unflatten(state, [t.float() if t.dtype == BF16 else t
                                  for _, t in tree_items(state)])


def make_pair(name, jkw, tkw, cfg, lr=0.1):
    jopt = jo.make_optimizer(name, j_cosine_warmup(lr, 1, 3), **jkw)
    make = lambda kw: make_optimizer(name, cosine_warmup(lr, 1, 3), cfg=cfg, **kw)
    return jopt, make(tkw), make(f32_twin(name, tkw))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_update_rule_matches_the_reference(rng, case):
    _, name, jkw, tkw = case
    params = jax.tree_util.tree_map(lambda s: rng.normal(size=s).astype(np.float32), SHAPES,
                                    is_leaf=lambda x: isinstance(x, tuple))
    jopt, opt, opt32 = make_pair(name, jkw, tkw, cfg=None)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = jax.tree_util.tree_map(torch.tensor, params)
    js = jopt.init(jp)
    template = opt.init(tp)
    for step in range(3):  # the first step's gradient norm is clipped
        g = jax.tree_util.tree_map(
            lambda p: (rng.normal(size=p.shape) * (3 if step == 0 else 0.1)).astype(np.float32),
            params)
        ts = from_ref(template, js)  # the reference's state, as the port's
        tu, ts = opt.update(jax.tree_util.tree_map(torch.tensor, g), ts, tp)
        _, ts32 = opt32.update(jax.tree_util.tree_map(torch.tensor, g), upcast(
            from_ref(template, js)), tp)
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        for (key, a), b in zip(tree_items(tu), jax.tree_util.tree_leaves(ju)):
            assert rel(to_np(a), b) < TOL, (step, key, rel(to_np(a), b))
        assert_states(ts, js, ts32, f"step {step} ")
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, ju)
        tp = jax.tree_util.tree_map(lambda p: torch.from_numpy(np.array(p)), jp)


def test_bf16_cast_rounds_as_xla_astype():
    # a sweep of f32 patterns, and at every exponent and sign mantissas that
    # tie (to an even and to an odd bf16), lie one ulp off a tie, or carry
    # into the exponent
    sweep = np.arange(0, 2**32, 4099, dtype=np.uint64).astype(np.uint32)
    exps = (np.arange(256, dtype=np.uint32) << 23)[:, None]
    lows = np.array([0x8000, 0x18000, 0x7FFF, 0x8001, 0x17FFF, 0x7FFFFF], np.uint32)
    edge = (exps | lows[None, :]).ravel()
    bits = np.concatenate([sweep, edge, edge | np.uint32(0x80000000)])
    x = bits.view(np.float32)
    x = x[np.isfinite(x)]
    want = np.asarray(jax.jit(lambda a: a.astype(jnp.bfloat16))(x)).view(np.uint16)
    got = torch.from_numpy(x).to(BF16).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module", params=["smollm-135m", "zamba2-7b"])
def model(request):
    arch = request.param
    jcfg, cfg = j_get_reduced(arch), get_reduced(arch)
    rng = np.random.default_rng(1)
    shapes = jax.eval_shape(lambda: j_lm_init(jax.random.PRNGKey(0), jcfg))
    params = jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) / 8).astype(np.float32), shapes)
    return arch, jcfg, cfg, params


@pytest.mark.parametrize("momentum", [0.9, None], ids=["bf16_momentum", "no_momentum"])
def test_adafactor_state_and_update_on_a_stacked_model(model, momentum):
    arch, jcfg, cfg, params = model
    rng = np.random.default_rng(2)
    jkw = {"momentum": momentum, "weight_decay": 0.1}
    jopt, opt, opt32 = make_pair("adafactor", jkw, jkw, cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = params_from_jax(params, cfg, device="cpu")
    js = jopt.init(jp)
    template = opt.init(tp)
    assert isinstance(template, AdafactorState)
    # the state is the reference's, path for path and shape for shape
    assert {k: tuple(t.shape) for k, t in tree_items(template)} == {
        k: v.shape for k, v in flat(js).items()}
    if arch == "zamba2-7b":  # a norm scale of the run of 2 mamba blocks: factored
        v = template.v["blocks"]["group"]["r0"]["norm1"]["scale"]
        assert isinstance(v, FactoredV)
        d = cfg.d_model
        assert (v.row.shape, v.col.shape, v.full.shape) == ((2, 2), (2, d), (1,))
    for step in range(3):
        g = jax.tree_util.tree_map(
            lambda p: (rng.normal(size=p.shape) * (1.0 if step == 0 else 1e-3)).astype(
                np.float32), params)
        ts = from_ref(template, js)
        tg = params_from_jax(g, cfg, device="cpu")
        tu, ts = opt.update(tg, ts, tp)
        _, ts32 = opt32.update(tg, upcast(from_ref(template, js)), tp)
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        ref, got = flat(ju), dict(tree_items(params_to_numpy(tu, cfg)))
        assert got.keys() == ref.keys()
        for key in ref:
            assert rel(got[key], ref[key]) < TOL, (arch, step, key, rel(got[key], ref[key]))
        assert_states(ts, js, ts32, f"{arch} step {step} ")
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, ju)
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")


def test_adafactor_needs_the_model_config(model):
    _, _, cfg, params = model
    tp = params_from_jax(params, cfg, device="cpu")
    with pytest.raises(TypeError):
        adafactor(cosine_warmup(0.1, 1, 3))  # cfg is a required keyword
    with pytest.raises(ValueError, match="cfg="):
        adafactor(cosine_warmup(0.1, 1, 3), cfg=None).init(tp)


def test_make_optimizer_names():
    sched = cosine_warmup(0.1, 1, 3)
    for name, state in (("adamw", "AdamState"), ("adafactor", "AdafactorState"),
                        ("sgdm", "SgdState")):
        opt = make_optimizer(name, sched, cfg=None)
        assert type(opt.init({"w": torch.zeros(2, 3)})).__name__ == state
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("lion", sched, cfg=None)
    assert adamw(sched).init({"w": torch.zeros(2)}).m["w"].dtype == torch.float32
    assert sgdm(sched, state_dtype=BF16).init({"w": torch.zeros(2)}).m["w"].dtype == BF16


WHOLE = [("smollm-135m", "adafactor", {}), ("zamba2-7b", "adafactor", {}),
         ("smollm-135m", "adamw", {"state_dtype": "bfloat16"}),
         ("smollm-135m", "sgdm", {})]
STEPS, SEQ, BATCH, LR = 4, 32, 4, 3e-3


@pytest.mark.parametrize("arch,name,kw", WHOLE, ids=[f"{a}-{n}{'-bf16' if k else ''}"
                                                     for a, n, k in WHOLE])
def test_whole_steps_match_the_jax_train_step(arch, name, kw):
    jcfg, cfg = j_get_reduced(arch), get_reduced(arch)
    dt = {k: getattr(jnp, v) for k, v in kw.items()}
    tdt = {k: getattr(torch, v) for k, v in kw.items()}
    jopt = jo.make_optimizer(name, j_cosine_warmup(LR, 2, STEPS), **dt)
    opt = make_optimizer(name, cosine_warmup(LR, 2, STEPS), cfg=cfg, **tdt)
    jstate = j_train_state_init(jax.random.PRNGKey(0), jcfg, jopt)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params), cfg,
                             device="cpu")
    state = TrainState(torch.zeros((), dtype=torch.int32), params, opt.init(params))
    jstep, step = jax.jit(j_make_train_step(jcfg, jopt)), make_train_step(cfg, opt)
    task = j_make_task("bigram", cfg.vocab, SEQ, BATCH, seed=0)
    for s in range(STEPS):
        batch = task.batch_at(s)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert rel(float(m["loss"]), float(jm["loss"])) < 1e-4, (s, float(m["loss"]))
    assert int(state.step) == int(jstate.step) == STEPS
    ours = dict(tree_items(to_jax_layout_state(state, cfg)))
    theirs = flat(jstate)
    assert ours.keys() == theirs.keys()
    for key, t in ours.items():
        assert tuple(t.shape) == theirs[key].shape, key
        if key.startswith(".params"):
            err = float(np.abs(to_np(t) - theirs[key]).max())
            assert err < 0.1 * STEPS * LR, (key, err)
