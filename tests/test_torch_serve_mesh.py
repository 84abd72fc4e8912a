"""The port's serving on a mesh against the JAX package.

Specs need no ranks: ``slot_cache_specs`` (dense and with each codec's
``state=``), ``cache_specs`` and the backends' ``cache_pspec`` /
``cross_cache_pspec`` equal the JAX package's leaf for leaf on stand-in
meshes {data 2, model 2}, {2, 4} and {7, 13} (the last replicates every
leaf), for the ten reduced configs.

The sharded ``ServeEngine`` runs on ``gloo`` ranks (one torch thread
each, a file store under the test's temporary directory): one spawn of 4
ranks (2×2 meshes) and one of 2 (1×2 and 2×1), each running all its
cases.  Tokens are exact everywhere: the greedy tokens of every rank equal
the JAX package's single-device engine's on the same weights (reduced
qwen2-1.5b with late and chunked admission, granite-20b's MQA d_v
fallback, the hybrid schedule, mamba2-780m, both speculative proposers,
NaN isolation); a trace replay's ``to_json()`` and sampled requests equal
the port's single-device engine's (which tests/test_torch_sched.py and
tests/test_torch_serve.py hold to the JAX engine).  The codec grid's
round trips and reads are bit for bit, and each rank's stored blocks,
gathered, equal the single-device store's bytes (quantised scales
included).  Each rank holds only the block of the slot cache that its spec
names.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.backends import available_backends, get_backend
from repro_torch.configs import ARCHS, get_reduced
from repro_torch.distributed import api as dist_api
from repro_torch.distributed import collectives as col
from repro_torch.distributed import spmd
from repro_torch.distributed.api import P
from repro_torch.distributed.sharding import (
    Placements,
    cache_specs,
    distribute_tree,
    gather_tree,
    global_shape,
    slot_cache_specs,
)
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.launch.spawn import run_ranks
from repro_torch.models.convert import params_from_jax
from repro_torch.models.lm import lm_init_caches, lm_prefill
from repro_torch.serve import (
    FaultPlan,
    Request,
    SchedulerPolicy,
    ServeEngine,
    SlotCorruption,
    Status,
    bursty_trace,
    make_state_store,
    run_trace,
)
from repro_torch.tree import tree_items, tree_leaves


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeMesh:
    """Just enough of a mesh for the specs' divisibility checks."""

    def __init__(self, sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


MESHES = ({"data": 2, "model": 2}, {"data": 2, "model": 4}, {"data": 7, "model": 13})
SLOTS, N_MAX = 4, 32

# ---------------------------------------------------------------------------
# Specs against the JAX package (no ranks)
# ---------------------------------------------------------------------------


def _jax_specs(tree):
    import jax
    from jax.sharding import PartitionSpec as JP

    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return [(jax.tree_util.keystr(p), tuple(x)) for p, x in flat]


def _port_specs(tree):
    return [(path, tuple(x)) for path, x in tree_items(tree)]


def _same(jtree, ptree, what):
    j, p = _jax_specs(jtree), _port_specs(ptree)
    assert [s for _, s in j] == [s for _, s in p], (what, j, p)
    assert len(j) == len(p)


def _configs(arch):
    from repro.configs import get_reduced as j_get_reduced

    return j_get_reduced(arch), get_reduced(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_cache_specs_equal_the_jax_packages(arch):
    """Every leaf of the dense slotted cache, on each stand-in mesh: the
    slot axis over "data", kv heads (or d_v) over "model", SSD heads and
    conv channels over "model", ``kv_src`` over "data"; {7, 13} replicates
    everything."""
    from repro.distributed.sharding import slot_cache_specs as j_slot_cache_specs

    jcfg, cfg = _configs(arch)
    rules = dict(dist_api.SINGLE_POD_RULES)
    for sizes in MESHES:
        mesh = FakeMesh(sizes)
        specs = slot_cache_specs(cfg, SLOTS, N_MAX, mesh, rules)
        _same(j_slot_cache_specs(jcfg, SLOTS, N_MAX, mesh, rules), specs, (arch, sizes))
        whole = lm_init_caches(cfg, SLOTS, N_MAX, device="meta")
        assert len(tree_leaves(specs)) == len(tree_leaves(whole))
        if sizes["data"] == 7:
            assert all(e is None for s in tree_leaves(specs) for e in s), (arch, specs)
        elif sizes == MESHES[0]:
            assert any("data" in tuple(s) for s in tree_leaves(specs)), arch


CODECS = {
    "int8": ("qwen2-1.5b", {}, dict(state_dtype="int8")),
    "fp8": ("qwen2-1.5b", {}, dict(state_dtype="fp8")),
    "paged": ("qwen2-1.5b", dict(attention="softmax"), dict(kv_page_size=8)),
    "int8+paged": ("qwen2-1.5b", dict(pattern=("attn", "attn"), n_groups=1,
                                      attention_schedule={1: "softmax"}),
                   dict(state_dtype="int8", kv_page_size=8)),
}


@pytest.mark.parametrize("name", list(CODECS))
def test_codec_specs_equal_the_jax_packages(name):
    """``slot_cache_specs(state=codec)``: a quantised payload keeps the
    dense spec and its scale replicates; page pools take the dense K/V
    specs ("data" on the page axis where it divides), the page table and
    lengths replicate."""
    from repro.distributed.sharding import slot_cache_specs as j_slot_cache_specs
    from repro.serve import make_state_store as j_make_state_store

    arch, over, kw = CODECS[name]
    jcfg, cfg = _configs(arch)
    jcfg, cfg = jcfg.replace(**over), cfg.replace(**over)
    rules = dict(dist_api.SINGLE_POD_RULES)
    jcodec = j_make_state_store(jcfg, SLOTS, N_MAX, "float32", **kw).codec
    codec = make_state_store(cfg, SLOTS, N_MAX, "cpu", **kw).codec
    assert codec.name == jcodec.name == name
    for sizes in MESHES:
        mesh = FakeMesh(sizes)
        _same(j_slot_cache_specs(jcfg, SLOTS, N_MAX, mesh, rules, state=jcodec),
              slot_cache_specs(cfg, SLOTS, N_MAX, mesh, rules, state=codec), (name, sizes))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-20b", "mamba2-780m", "zamba2-7b"])
def test_cache_specs_of_a_prefill_equal_the_jax_packages(arch):
    """``cache_specs`` on ``lm_prefill``'s caches at a batch of 4 (the batch
    dim found by its size, heads after it, the last-dim fallback)."""
    from repro.distributed.sharding import cache_specs as j_cache_specs
    from repro.models.lm import lm_init_caches as j_lm_init_caches

    jcfg, cfg = _configs(arch)
    rules = dict(dist_api.SINGLE_POD_RULES)
    jshapes = j_lm_init_caches(jcfg, 4, N_MAX)
    shapes = lm_init_caches(cfg, 4, N_MAX, device="meta")
    for sizes in MESHES:
        mesh = FakeMesh(sizes)
        _same(j_cache_specs(jshapes, mesh, rules, 4), cache_specs(shapes, mesh, rules, 4),
              (arch, sizes))


def test_backend_cache_pspecs_equal_the_jax_packages():
    """Each backend's logical ``cache_pspec`` and ``cross_cache_pspec``
    (Taylor order 1 and 2, full and ``sym_state``; the KV backends; the SSM
    block)."""
    from repro.backends import get_backend as j_get_backend

    jcfg, cfg = _configs("qwen2-1.5b")
    variants = [dict(), dict(order=1), dict(sym_state=True)]
    for name, backend in sorted(available_backends().items()):
        for v in variants if name == "taylor" else [{}]:
            jc = jcfg.replace(taylor=dataclasses.replace(jcfg.taylor, **v))
            c = cfg.replace(taylor=dataclasses.replace(cfg.taylor, **v))
            jb = j_get_backend(name)
            _same(jb.cache_pspec(jc), backend.cache_pspec(c), (name, v))
            _same(jb.cross_cache_pspec(jc), backend.cross_cache_pspec(c), (name, v))


def test_the_mqa_spec_puts_model_on_the_last_dim():
    """granite-20b's one kv head cannot split: the value moments s0/s1/s2
    shard d_v over "model" and the key moments z1/z2 their last (key)
    dim; ``n0`` replicates (the reference's resolver)."""
    cfg = get_reduced("granite-20b")
    rules = dict(dist_api.SINGLE_POD_RULES)
    state = slot_cache_specs(cfg, SLOTS, N_MAX, FakeMesh(MESHES[0]), rules)["group"][0]
    assert state.n0 == P(None, None, "data", None)
    for leaf in (state.s0, state.z1, state.s1, state.z2, state.s2):
        assert tuple(leaf)[2] == "data" and tuple(leaf)[-1] == "model", state
    assert spmd.attn_mode(cfg, 2) == "dv" and spmd.attn_mode(get_reduced("qwen2-1.5b"), 2) == "heads"


# ---------------------------------------------------------------------------
# The sharded engine on gloo ranks
# ---------------------------------------------------------------------------

HYBRID = dict(pattern=("attn", "attn"), n_groups=1, attention="taylor",
              attention_schedule={1: "softmax_window"}, attn_window=16)
MIXED = dict(pattern=("attn", "attn"), n_groups=1, attention="taylor",
             attention_schedule={1: "softmax"})


def _prompts(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


# (arch, config overrides, engine kwargs, prompt seed, prompt lengths, budgets,
# requests submitted before the first step): the JAX package's mesh tests'
CASES = {
    "qwen": ("qwen2-1.5b", {}, dict(max_slots=2, n_max=64, decode_block=3), 0,
             (16, 9, 21, 33), (6, 9, 4, 5), 2),
    "softmax": ("qwen2-1.5b", dict(attention="softmax"),
                dict(max_slots=2, n_max=64, decode_block=3), 0, (16, 9, 21, 33), (6, 9, 4, 5), 2),
    "granite": ("granite-20b", {}, dict(max_slots=4, n_max=64, decode_block=4), 1,
                (10, 17, 8), (5, 5, 5), 3),
    "hybrid": ("qwen2-1.5b", HYBRID, dict(max_slots=2, n_max=96, decode_block=3), 15,
               (19, 9), (6, 6), 2),
    "mamba": ("mamba2-780m", {}, dict(max_slots=2, n_max=64, decode_block=3), 2,
              (12, 7, 20), (5, 6, 4), 2),
    "smollm": ("smollm-135m", {}, dict(max_slots=2, n_max=64, decode_block=4), 5,
               (4, 11, 7, 9), (12, 8, 17, 10), 4),
}
DRAFTS = ("ngram", "order1")
# (name, case, engine kwargs): the stored representations served on 2×2
STORES = (("int8", "qwen", dict(state_dtype="int8")), ("fp8", "qwen", dict(state_dtype="fp8")),
          ("paged", "softmax", dict(kv_page_size=8)))


def _cfg(name):
    arch, over, *_ = CASES[name]
    return get_reduced(arch).replace(**over)


def _serve(name, params, mesh, results=False, **kw):
    """The case's requests through a port engine (``mesh=None``: one device);
    returns the tokens (or results) in submission order and the engine."""
    _, _, eng_kw, seed, lens, budgets, first = CASES[name]
    cfg = _cfg(name)
    eng = ServeEngine(params, cfg, device="cpu", mesh=mesh, **{**eng_kw, **kw})
    reqs = [Request(tokens=p, max_new_tokens=b)
            for p, b in zip(_prompts(seed, lens, cfg.vocab), budgets)]
    rids = [eng.submit(r) for r in reqs[:first]]
    if first < len(reqs):
        eng.step()  # the first requests mid-flight: the rest are late admissions
        rids += [eng.submit(r) for r in reqs[first:]]
    out = eng.run(return_results=results)
    return [out[r] if results else out[r].tolist() for r in rids], eng


def _local_shapes_ok(eng):
    """Each leaf of the engine's stored slot cache against its spec: the
    block's shape times the spec's axis sizes is the whole leaf's."""
    codec = eng.state_store.codec
    whole = dataclasses.replace(codec, device=torch.device("meta"), mesh=None).init_stored()
    specs = eng.state_store.placements.specs
    return all(global_shape(x.shape, s, eng.mesh) == tuple(w.shape)
               for x, s, w in zip(tree_leaves(eng.caches), tree_leaves(specs),
                                  tree_leaves(whole)))


def _grid(mesh):
    """The conformance grid on a mesh: for every (backend, representation)
    a sharded and a one-device store take the same batch-1 states; returns
    ``{(backend, rep): {check: bool}}``."""
    rules = dist_api.rules_for_mesh(mesh)
    slots, n_max, page, lens = 2, 32, 8, (7, 12)
    out = {}
    combos = []
    for name, backend in sorted(available_backends().items()):
        cfg = get_reduced("mamba2-780m" if backend.level == "block" else "qwen2-1.5b")
        if backend.level != "block":
            cfg = cfg.replace(attention=name)
        reps = list(backend.state_dtypes) + (["paged"] if backend.supports_paged_kv else [])
        combos += [(name, rep, cfg) for rep in reps]
    combos.append(("taylor+softmax", "int8+paged", get_reduced("qwen2-1.5b").replace(**MIXED)))
    combos.append(("taylor mqa", "int8", get_reduced("granite-20b")))  # scales over split d_v
    from repro_torch.models import lm_init

    for name, rep, cfg in combos:
        params = lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
        states = [lm_prefill(params, {"tokens": torch.as_tensor(p[None])}, cfg, n_max)[1]
                  for p in _prompts(100, lens, cfg.vocab)]
        kw = ({"state_dtype": "int8", "kv_page_size": page} if rep == "int8+paged" else
              {"state_dtype": rep} if rep in ("int8", "fp8") else
              {"kv_page_size": page} if rep == "paged" else {})
        one = make_state_store(cfg, slots, n_max, "cpu", **kw)
        store = make_state_store(cfg, slots, n_max, "cpu", mesh=mesh, rules=rules, **kw)
        b1 = Placements(mesh, slot_cache_specs(cfg, 1, n_max, mesh, rules))
        c1, caches = one.init_caches(), store.init_caches()
        for j, st in enumerate(states):
            c1 = one.ensure_tokens(c1, j, lens[j])
            c1 = one.write_slot(c1, st, j)
            caches = store.ensure_tokens(caches, j, lens[j])
            caches = store.write_slot(caches, distribute_tree(st, b1), j)
        checks = {"blocks": all(global_shape(x.shape, s, mesh) == tuple(w.shape) for x, s, w in
                                zip(tree_leaves(caches), tree_leaves(store.placements.specs),
                                    tree_leaves(c1)))}
        whole = gather_tree(caches, store.placements)
        checks["stored == one device"] = all(torch.equal(a, b) for a, b in
                                             zip(tree_leaves(whole), tree_leaves(c1)))
        reads = [gather_tree(store.read_slot(caches, j), b1) for j in range(slots)]
        want = [one.read_slot(c1, j) for j in range(slots)]
        checks["read"] = all(torch.equal(a, b) for r, w in zip(reads, want)
                             for a, b in zip(tree_leaves(r), tree_leaves(w)))
        if rep not in ("dense", "paged"):  # a lossy read written back: the same bits
            for j in range(slots):
                caches = store.write_slot(caches, store.read_slot(caches, j), j)
            again = gather_tree(caches, store.placements)
            checks["round trip"] = all(torch.equal(a, b) for a, b in
                                       zip(tree_leaves(again), tree_leaves(whole)))
        else:
            checks["round trip"] = all(torch.equal(a, b) for r, st in zip(reads, states)
                                       for a, b in zip(tree_leaves(r), tree_leaves(st)))
        before = gather_tree(store.read_slot(caches, 0), b1)
        caches = store.clear_slot(caches, 1)
        after = gather_tree(store.read_slot(caches, 0), b1)
        checks["clear isolation"] = all(torch.equal(a, b) for a, b in
                                        zip(tree_leaves(after), tree_leaves(before)))
        checks["healthy"] = bool(store.health(caches).all())
        if "paged" not in rep:  # NaN in one "model" rank's block of slot 1 only
            lone = (store.corrupt_slot(caches, 1, float("nan"))
                    if col.axis_rank(mesh, "model") == 0 else caches)
            checks["one block flags its slot"] = store.health(lone).tolist() == [True, False]
        caches = store.corrupt_slot(caches, 0, float("nan"))
        checks["nan flagged"] = store.health(caches).tolist() == [False, True]
        out[(name, rep)] = checks
    return out


def _teacher(params, name, mesh, steps=4):
    """A sharded engine's weights through ``lm_prefill`` and ``lm_decode_step``
    (a batch of 2 whole on every "data" rank, teacher-forced) against one
    device's: the largest of max |Δlogits| / max |logits| over the steps."""
    from repro_torch.models.lm import lm_decode_step

    cfg = _cfg(name)
    eng = ServeEngine(params, cfg, max_slots=2, n_max=64, mesh=mesh, device="cpu")
    toks = torch.as_tensor(np.stack(_prompts(9, (12, 12), cfg.vocab))).long()
    follow = torch.as_tensor(np.stack(_prompts(10, (steps, steps), cfg.vocab))).long()
    worst = 0.0
    with eng._on_mesh(slotted=False):
        got, caches = lm_prefill(eng.params, {"tokens": toks}, cfg, 64)
    want, wcaches = lm_prefill(params, {"tokens": toks}, cfg, 64)
    for t in range(steps + 1):
        worst = max(worst, float((got - want).abs().max() / want.abs().max()))
        if t == steps:
            break
        with eng._on_mesh(slotted=False):
            got, caches = lm_decode_step(eng.params, follow[:, t], caches, 12 + t, cfg)
        want, wcaches = lm_decode_step(params, follow[:, t], wcaches, 12 + t, cfg)
    return worst


def _four(rank, world, jparams):
    mesh = make_serve_mesh(2, 2, device="cpu")
    params = {k: params_from_jax(v, _cfg(k), device="cpu") for k, v in jparams.items()}
    out = {}
    toks, eng = _serve("qwen", params["qwen"], mesh)
    out["qwen_2x2"] = toks
    out["qwen_2x2_blocks"] = _local_shapes_ok(eng)
    out["qwen_2x2_bytes"] = eng.live_state_bytes
    for name, case, kw in STORES:
        toks, eng = _serve(case, params["qwen"], mesh, **kw)
        out[name] = (toks, _local_shapes_ok(eng))
    toks, eng = _serve("granite", params["granite"], mesh)
    out["granite"] = (toks, _local_shapes_ok(eng))
    out["hybrid"] = _serve("hybrid", params["hybrid"], mesh)[0]
    out["mamba"] = _serve("mamba", params["mamba"], mesh, prefill_chunk=8)[0]
    out["spec"] = {}
    for draft in DRAFTS:
        toks, eng = _serve("smollm", params["smollm"], mesh,
                           sched=SchedulerPolicy(speculative_k=4, speculative_draft=draft))
        out["spec"][draft] = (toks, eng.stats())
    plan = FaultPlan(events=(SlotCorruption(at_block=1, slot=1, mode="nan"),))
    res, eng = _serve("smollm", params["smollm"], mesh, results=True, fault_plan=plan)
    out["nan"] = ([r.status.value for r in res], [r.tokens.tolist() for r in res], eng.stats())
    out["trace"] = [_replay(params["smollm"], mesh) for _ in range(2)]
    out["sampled"] = _sampled(params["qwen"], mesh)
    out["grid"] = _grid(mesh)
    out["errors"] = _refusals(mesh)
    out["teacher"] = {k: _teacher(params[k], k, mesh) for k in ("qwen", "granite", "hybrid",
                                                                 "mamba")}
    return out


def _two(rank, world, jparams):
    params = params_from_jax(jparams["qwen"], _cfg("qwen"), device="cpu")
    out = {}
    for shape in ((1, 2), (2, 1)):
        mesh = make_serve_mesh(*shape, device="cpu")
        toks, eng = _serve("qwen", params, mesh)
        out[shape] = (toks, _local_shapes_ok(eng), eng.live_state_bytes)
    out["chunked"] = _serve("qwen", params, make_serve_mesh(1, 2, device="cpu"),
                            prefill_chunk=8)[0]
    return out


def _replay(params, mesh):
    """tests/test_load.py:423's SLO replay: bursty, priority admission and
    preemption, chunked prefill."""
    cfg = _cfg("smollm")
    trace = bursty_trace(6, 8, cfg.vocab, calm_interarrival_s=0.002,
                         burst_interarrival_s=0.0002, prompt_len=(4, 20), new_tokens=(3, 10),
                         priorities=(0, 5))
    sched = SchedulerPolicy(priority_admission=True, decode_per_prefill=2, fat_chunk_depth=3,
                            preemption=True)
    return run_trace(lambda clock: ServeEngine(params, cfg, max_slots=2, n_max=64,
                                               decode_block=4, prefill_chunk=8, clock=clock,
                                               sched=sched, mesh=mesh, device="cpu"),
                     trace, "slo").to_json()


def _sampled(params, mesh):
    """Two sampled requests (temperature 1, one with top-k 5) beside a
    greedy one, the engine's default generator (seed 0)."""
    cfg = _cfg("qwen")
    eng = ServeEngine(params, cfg, max_slots=2, n_max=64, decode_block=3, mesh=mesh,
                      device="cpu")
    prompts = _prompts(7, (11, 6, 14), cfg.vocab)
    rids = [eng.submit(Request(tokens=p, max_new_tokens=8, temperature=t, top_k=k))
            for p, (t, k) in zip(prompts, ((1.0, 0), (1.0, 5), (0.0, 0)))]
    out = eng.run()
    return [out[r].tolist() for r in rids]


def _refusals(mesh):
    """The status and token count of a request served on the mesh by a MoE
    model and by each cross family (its source in ``extras``)."""
    from repro_torch.models import lm_init

    errors = {}
    rng = np.random.default_rng(3)
    for name, arch in (("moe", "qwen2-moe-a2.7b"), ("cross", "whisper-medium"),
                       ("vlm", "llama-3.2-vision-11b")):
        cfg = get_reduced(arch)
        params = lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
        eng = ServeEngine(params, cfg, max_slots=2, n_max=32, mesh=mesh, device="cpu")
        extras = ({"image_embeds": rng.normal(size=(1, cfg.n_image_tokens, cfg.vision_dim))}
                  if cfg.family == "vlm" else
                  {"audio_frames": rng.normal(size=(1, cfg.n_audio_ctx, cfg.d_model))}
                  if cfg.family == "encdec" else {})
        rid = eng.submit(Request(tokens=_prompts(3, (7,), cfg.vocab)[0], max_new_tokens=3,
                                 extras={k: v.astype(np.float32) for k, v in extras.items()}))
        res = eng.run(return_results=True)[rid]
        errors[name] = (res.status.value, len(res.tokens))
    return errors


def _jax_engine(name, jparams, **kw):
    """The JAX package's single-device engine on the case: greedy tokens."""
    from repro.configs import get_reduced as j_get_reduced
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JServeEngine

    arch, over, eng_kw, seed, lens, budgets, first = CASES[name]
    jcfg = j_get_reduced(arch).replace(**over)
    eng = JServeEngine(jparams, jcfg, **eng_kw, **kw)
    reqs = [JRequest(tokens=p, max_new_tokens=b)
            for p, b in zip(_prompts(seed, lens, jcfg.vocab), budgets)]
    rids = [eng.submit(r) for r in reqs[:first]]
    if first < len(reqs):
        eng.step()
        rids += [eng.submit(r) for r in reqs[first:]]
    out = eng.run()
    return [np.asarray(out[r]).tolist() for r in rids]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX single-device engines' tokens, the port's one-device replay
    and sampled tokens, then both spawns."""
    import jax

    from repro.configs import get_reduced as j_get_reduced
    from repro.models import lm_init as j_lm_init

    tmp = tmp_path_factory.mktemp("serve_mesh")
    jparams, jax_tokens = {}, {}
    for name in ("qwen", "granite", "hybrid", "mamba", "smollm"):
        arch, over, *_ = CASES[name]
        jcfg = j_get_reduced(arch).replace(**over)
        jp = j_lm_init(jax.random.PRNGKey(0), jcfg)
        jparams[name] = jax.tree_util.tree_map(np.asarray, jp)
        jax_tokens[name] = _jax_engine(name, jp)
        if name == "qwen":
            for store, case, kw in STORES:
                jax_tokens[store] = _jax_engine(case, jp, **kw)
    qwen = params_from_jax(jparams["qwen"], _cfg("qwen"), device="cpu")
    smollm = params_from_jax(jparams["smollm"], _cfg("smollm"), device="cpu")
    single = dict(trace=_replay(smollm, None), sampled=_sampled(qwen, None),
                  qwen_bytes=_serve("qwen", qwen, None)[1].live_state_bytes)
    four = run_ranks(_four, 4, backend="gloo", init_file=str(tmp / "store4"), args=(jparams,))
    two = run_ranks(_two, 2, backend="gloo", init_file=str(tmp / "store2"), args=(jparams,))
    return dict(jax=jax_tokens, single=single, four=four, two=two)


@pytest.mark.parametrize("mesh", ["1x2", "2x1", "2x2", "1x2_chunked"])
def test_sharded_engine_tokens_equal_the_jax_single_device_engine(runs, mesh):
    """Reduced qwen2-1.5b (GQA, 2 kv heads): late admission on every mesh,
    and a 1×2 engine that admits the 33-token prompt in chunks of 8."""
    want = runs["jax"]["qwen"]
    if mesh == "2x2":
        got = [rk["qwen_2x2"] for rk in runs["four"]]
        assert all(rk["qwen_2x2_blocks"] for rk in runs["four"])
    elif mesh == "1x2_chunked":
        got = [rk["chunked"] for rk in runs["two"]]
    else:
        shape = tuple(int(x) for x in mesh.split("x"))
        got = [rk[shape][0] for rk in runs["two"]]
        assert all(rk[shape][1] for rk in runs["two"])
    for toks in got:
        assert toks == want


@pytest.mark.parametrize("case", ["qwen", "granite", "hybrid", "mamba"])
def test_teacher_forced_logits_on_2x2_equal_one_devices(runs, case):
    """The sharded forward's logits, prefill then 4 decode steps on the
    same tokens: heads split (qwen2), d_v split (granite), a window ring
    beside the moments (hybrid), the SSD state gathered around each step
    (mamba2); relative 1e-5 of one device's (float32 sums in another
    order)."""
    for rk in runs["four"]:
        assert rk["teacher"][case] < 1e-5, rk["teacher"]


def test_each_rank_holds_its_block_of_the_slot_cache(runs):
    """1×2 splits the heads (half the bytes a rank), 2×1 the slots (the
    same half), 2×2 both (a quarter)."""
    whole = runs["single"]["qwen_bytes"]
    for shape in ((1, 2), (2, 1)):
        assert all(rk[shape][2] * 2 == whole for rk in runs["two"]), shape
    assert all(rk["qwen_2x2_bytes"] * 4 == whole for rk in runs["four"])


@pytest.mark.parametrize("store", [name for name, _, _ in STORES])
def test_stored_representations_on_a_mesh_keep_the_tokens(runs, store):
    """int8 and fp8 moment stores on 2×2 (replicated scales, so the stored
    bytes are the one-device engine's) and a paged softmax KV store (its
    pool's pages over "data") give the JAX engine's tokens of the same
    representation, with blocks as specified."""
    for rk in runs["four"]:
        toks, blocks = rk[store]
        assert blocks and toks == runs["jax"][store]


def test_mqa_dv_fallback_tokens_equal_the_jax_engine(runs):
    """Reduced granite-20b (4 query heads over 1 kv head) on 2×2: each rank
    holds the d_v columns of the value moments; tokens exact."""
    for rk in runs["four"]:
        toks, blocks = rk["granite"]
        assert blocks and toks == runs["jax"]["granite"]


@pytest.mark.parametrize("case", ["hybrid", "mamba"])
def test_hybrid_schedule_and_mamba2_on_2x2(runs, case):
    """The taylor / softmax_window hybrid (per-run caches of two kinds) and
    mamba2-780m (its SSD state gathered around each step, chunked
    admission in chunks of 8) on 2×2."""
    for rk in runs["four"]:
        assert rk[case] == runs["jax"][case]


@pytest.mark.parametrize("draft", DRAFTS)
def test_speculation_on_2x2_is_token_identical_to_plain_decode(runs, draft):
    for rk in runs["four"]:
        toks, st = rk["spec"][draft]
        assert toks == runs["jax"]["smollm"]
        assert st["spec_rounds"] > 0 and st["spec_accepted"] > 0
    assert len({str(rk["spec"][draft][1]["spec_accepted"]) for rk in runs["four"]}) == 1


def test_nan_isolation_on_2x2(runs):
    """A NaN poured into slot 1's blocks after block 1 (request 1, still
    decoding): every request ends OK with the JAX engine's fault-free
    tokens, and every rank counts the one quarantine."""
    for rk in runs["four"]:
        statuses, toks, st = rk["nan"]
        assert statuses == [Status.OK.value] * 4
        assert toks == runs["jax"]["smollm"]
        assert st["quarantined"] == 1 and st["corruptions_injected"] == 1


def test_trace_replay_on_2x2_is_byte_identical(runs):
    """``run_trace(...).to_json()`` of the same SLO replay: equal across two
    runs on the mesh, across the ranks and to the one-device replay."""
    want = runs["single"]["trace"]
    for rk in runs["four"]:
        assert rk["trace"][0] == rk["trace"][1] == want


def test_sampled_requests_draw_the_one_device_tokens(runs):
    """Sampling picks from the logits gathered over "data" with the engine's
    one generator: every rank draws the one-device engine's tokens."""
    for rk in runs["four"]:
        assert rk["sampled"] == runs["single"]["sampled"]


def test_codec_grid_on_2x2(runs):
    """Every (backend, representation), int8 + paged under one hybrid store,
    and int8 on granite-20b (d_v split: each scale a max over "model"):
    stored blocks equal the one-device store's bytes (replicated
    scales included), reads and round trips bit for bit, a clear leaves
    the other slot, health flags only the poisoned slot."""
    grid = runs["four"][0]["grid"]
    expected = {(name, rep) for name, b in available_backends().items()
                for rep in list(b.state_dtypes) + (["paged"] if b.supports_paged_kv else [])}
    assert expected | {("taylor+softmax", "int8+paged"), ("taylor mqa", "int8")} == set(grid)
    for rk in runs["four"]:
        bad = {combo: [k for k, ok in checks.items() if not ok]
               for combo, checks in rk["grid"].items() if not all(checks.values())}
        assert not bad, bad


def test_what_a_serving_mesh_refuses(runs):
    """Nothing of the zoo: reduced qwen2-moe, whisper-medium and
    llama-3.2-vision-11b each serve a request on 2×2
    (tests/test_torch_moe_mesh.py and tests/test_torch_cross_mesh.py hold
    their tokens and logits to the JAX package)."""
    errors = runs["four"][0]["errors"]
    for name in ("moe", "cross", "vlm"):
        assert errors[name] == ("ok", 3), (name, errors[name])
    assert get_backend("taylor").value_leaves == ("s0", "s1", "s2")
