"""The rank side of tests/test_torch_sharded_layouts.py, and its fake-mesh
worker. It imports only the port (a spawned rank imports this module, not
the test module).

Four spawned gloo ranks of a 2×2 (data, model) mesh run ``rank_main``:
TinyLlama's and reduced xLSTM-125M's prefill and decode, an attention
whose heads the model axis does not divide, and the mLSTM, sLSTM, SSD
and conv regions, each on seeded inputs the test module's 1×1 runs share
(``case_inputs``); a rank drains its collectives before it leaves the
group (``torch_procs.drain``).

``python tests/torch_layout_ranks.py fake|steps OUT`` runs the fake (4, 4)
mesh's cases in a process of its own (torch's fake process group is its
process's one default group): the prefills' cache blocks and largest
allocation, the attention's largest score tile, the sLSTM region's FLOPs
and collectives, and the xLSTM dry run's chunk count ("fake"); the trace of every step it is held to ("steps", a
second process, run beside the first).
"""
import contextlib
import dataclasses
import datetime
import functools
import os
import pickle
import sys
import warnings

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as txl
from repro_torch.models.common import BLOCK_AXES, tree_leaves
from repro_torch.models.scan import chunked_scan
from repro_torch.sharding import MeshRules, use_rules
from repro_torch.sharding.specs import sharded_compute
from repro_torch.training.optimizer import whole

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_procs import drain  # noqa: E402

WORLD = 4

# A: TinyLlama (reduced) prefill, then greedy decode, in f32
PROMPT, MAX_SEQ, N_DECODE, DECODE_BATCH = 16, 24, 4, 2
# B: an attention sublayer with 3 heads and 1 kv head (Scout's GQA shape,
# 40 heads over 8 kv heads, at a size the model axis of 2 does not divide)
ATTN = dict(b=2, s=32, d=24, h=3, kv=1, hd=8)
ATTN_PATHS = ("direct", "blockwise")
# the blockwise path's threshold and tile for the test: 32 positions over
# tiles of 8 × 16
BLOCKWISE = dict(threshold=16, block_q=8, block_kv=16)
# C: the recurrences' regions at the reduced configs' widths (xLSTM-125M:
# 4 heads of dh 128; Zamba2-7B: 16 SSD heads of 32, state 16, conv_dim
# 544), batch 2 × 24 steps, chunks of 8 (three of them)
_XCFG = get_config("xlstm-125m").reduced()
_X = txl.XLSTMConfig(d_model=_XCFG.d_model, n_heads=_XCFG.n_heads)
_ZCFG = get_config("zamba2-7b").reduced()
_Z = tssm.Mamba2Config(d_model=_ZCFG.d_model, d_state=_ZCFG.ssm_state, d_conv=_ZCFG.ssm_conv,
                       expand=_ZCFG.ssm_expand, head_dim=_ZCFG.ssm_head_dim)
MLSTM = dict(b=2, s=24, h=_X.n_heads, dh=_X.head_dim, chunk=8)
SLSTM = dict(b=2, s=24, d=_X.d_model, h=_X.n_heads, chunk=8)
SSD = dict(b=2, s=24, h=_Z.n_heads, p=_Z.head_dim, n=_Z.d_state, chunk=8)
CONV = dict(b=2, s=24, c=_Z.conv_dim, d_conv=_Z.d_conv)


@contextlib.contextmanager
def f32():
    """The port's compute dtype set to f32 (as tests/test_torch_families.py
    sets it)."""
    old = tmodel.COMPUTE_DTYPE
    tmodel.COMPUTE_DTYPE = torch.float32
    try:
        yield
    finally:
        tmodel.COMPUTE_DTYPE = old


def case_inputs(seed=0):
    """Seeded numpy inputs of every 2×2 case."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (scale * rng.normal(size=shape)).astype(np.float32)

    a = ATTN
    attn = {"x": normal(a["b"], a["s"], a["d"]),
            "wq": normal(a["d"], a["h"] * a["hd"], scale=a["d"] ** -0.5),
            "wk": normal(a["d"], a["kv"] * a["hd"], scale=a["d"] ** -0.5),
            "wv": normal(a["d"], a["kv"] * a["hd"], scale=a["d"] ** -0.5),
            "wo": normal(a["h"] * a["hd"], a["d"], scale=(a["h"] * a["hd"]) ** -0.5),
            "g": normal(a["b"], a["s"], a["d"])}
    core = {n: normal(a["b"], a["s"], a["h"], a["hd"]) for n in ("q", "k", "v", "g")}
    m = MLSTM
    b, s, h, dh = m["b"], m["s"], m["h"], m["dh"]
    mlstm = {"q": normal(b, s, h, dh), "k": normal(b, s, h, dh, scale=dh ** -0.5),
             "v": normal(b, s, h, dh), "log_i": normal(b, s, h), "f_pre": normal(b, s, h) + 2,
             "c": normal(b, h, dh, dh, scale=0.1), "n": normal(b, h, dh, scale=0.1),
             "m": normal(b, h, scale=0.1),
             "gy": normal(b, s, h, dh), "gc": normal(b, h, dh, dh), "gn": normal(b, h, dh),
             "gm": normal(b, h)}
    d = SSD
    b, s, h = d["b"], d["s"], d["h"]
    dt = np.log1p(np.exp(normal(b, s, h))).astype(np.float32)
    ssd = {"xs": normal(b, s, h, d["p"]), "b_h": normal(b, s, h, d["n"]),
           "c_h": normal(b, s, h, d["n"]), "dt": dt,
           "da": (dt * -np.exp(normal(h, scale=0.5))).astype(np.float32),
           "gy": normal(b, s, h, d["p"]), "gs": normal(b, h, d["p"], d["n"])}
    c = CONV
    conv = {"x": normal(c["b"], c["s"], c["c"]), "w": normal(c["d_conv"], c["c"], scale=0.5),
            "bias": normal(c["c"]), "g": normal(c["b"], c["s"], c["c"])}
    lc = SLSTM
    b, s, d, h = lc["b"], lc["s"], lc["d"], lc["h"]
    sdh = d // h
    slstm = {"pre": normal(b, s, 4 * d), "r_w": normal(h, sdh, 4 * sdh, scale=sdh ** -0.5),
             "c": normal(b, d, scale=0.1), "n": np.abs(normal(b, d)) + 0.5,
             "m": normal(b, d, scale=0.1), "h": normal(b, d, scale=0.1),
             "gy": normal(b, s, d), "gc": normal(b, d), "gn": normal(b, d), "gm": normal(b, d),
             "gh": normal(b, d)}
    return {"attn": attn, "core": core, "mlstm": mlstm, "ssd": ssd, "conv": conv,
            "slstm": slstm}


def _numpy(tensors):
    return [whole(t).detach().numpy() for t in tensors]


def prefill_decode(rules=None):
    """TinyLlama (reduced, f32): the prefill's last logits and every
    decode step's logits and greedy tokens, whole."""
    cfg = get_config("tinyllama-1.1b").reduced()
    model = build_model(cfg)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(DECODE_BATCH, PROMPT)))
    with f32(), use_rules(rules), sharded_compute():
        params = model.init(seed=0, device="cpu")
        if rules is not None:
            params = rules.place(params, model.param_axes())
            tokens = rules.distribute(tokens, ("batch", None))
        logits, cache = model.prefill(params, {"tokens": tokens}, MAX_SEQ)
        out = {"logits": [whole(logits).numpy()], "tokens": []}
        for _ in range(N_DECODE):
            tok = whole(logits).argmax(-1)[:, None]
            out["tokens"].append(tok.numpy())
            if rules is not None:
                tok = rules.distribute(tok, ("batch", None))
            logits, _ = model.decode_step(params, tok, cache)
            out["logits"].append(whole(logits).numpy())
        out["k_local"] = tuple(cache["k"].to_local().shape) if rules is not None else None
    return out


def _attn_cfg(path):
    return contextlib.ExitStack() if path == "direct" else _blockwise_settings()


@contextlib.contextmanager
def _blockwise_settings():
    old_t, old_fn = tattn.BLOCKWISE_THRESHOLD, tattn._blockwise_attention
    tattn.BLOCKWISE_THRESHOLD = BLOCKWISE["threshold"]

    def small_tiles(q, k, v, q_offset, causal, window=None):
        return old_fn(q, k, v, q_offset, causal, window, block_q=BLOCKWISE["block_q"],
                      block_kv=BLOCKWISE["block_kv"])

    tattn._blockwise_attention = small_tiles
    try:
        yield
    finally:
        tattn.BLOCKWISE_THRESHOLD, tattn._blockwise_attention = old_t, old_fn


def attention(path, data, rules=None):
    """The attention sublayer (3 heads, 1 kv head; causal) on ``path``: its
    output and the gradients of <out, g> with respect to x and the four
    weights, whole; and whether the rules put q's sequence on 'model'."""
    a = ATTN
    names = ("wq", "wk", "wv", "wo")
    with _attn_cfg(path), use_rules(rules), sharded_compute():
        def place(name, logical):
            t = torch.from_numpy(data[name])
            return (rules.distribute(t, logical) if rules is not None else t).requires_grad_(True)

        params = {n: place(n, BLOCK_AXES[n]) for n in names}
        x = place("x", ("batch", None, "act_embed"))
        out = tattn.multi_head_attention(x, params, a["h"], a["kv"], a["hd"])
        loss = whole((out * torch.from_numpy(data["g"])).sum())
        grads = torch.autograd.grad(loss, [x] + [params[n] for n in names])
        seq_split = tattn._seq_on_model((a["b"], a["s"], a["h"], a["hd"]))
    return {"out": _numpy([out])[0], "grads": _numpy(grads), "seq_split": seq_split}


def attention_core(path, data, rules=None):
    """The causal core on q, k, v (b, s, h, hd) laid out as the sublayer
    lays them out: under rules each model rank's query rows
    (``_seq_split``), else the whole sequence. The output and the
    gradients of <out, g> with respect to q, k and v, whole."""
    s = ATTN["s"]
    with _attn_cfg(path), use_rules(rules), sharded_compute():
        def attend(qb, kb, vb, row0):
            if path == "blockwise":
                return tattn._blockwise_attention(qb, kb, vb, row0, True)
            mask = tattn._attention_mask(qb.shape[1], s, row0, None, qb.device)
            return tattn._direct_attention(qb, kb, vb, mask)

        axes = {"q": tattn.Q_AXES, "k": ("batch", None, "kv_heads", "head_dim"),
                "v": ("batch", None, "kv_heads", "head_dim")}
        qkv = [torch.from_numpy(data[n]) for n in "qkv"]
        if rules is not None:
            qkv = [rules.distribute(t, axes[n]) for t, n in zip(qkv, "qkv")]
        qkv = [t.requires_grad_(True) for t in qkv]
        out = tattn._seq_split(*qkv, attend) if rules is not None else attend(*qkv, 0)
        loss = whole((out * torch.from_numpy(data["g"])).sum())
        grads = torch.autograd.grad(loss, qkv)
    return {"out": _numpy([out])[0], "grads": _numpy(grads)}


def _flat(out):
    """The tensors of a region's nested tuples of outputs, in order."""
    if isinstance(out, tuple):
        return [t for o in out for t in _flat(o)]
    return [out]


def _region_run(region, args, axes, cots, rules):
    """``region(*args)`` with every argument a leaf, under ``rules`` (each
    argument distributed by its logical axes first): the outputs (flat,
    whole), the gradients of the sum of <output, cotangent> with respect
    to every argument (whole), and each output's local block and its
    placements."""
    with use_rules(rules), sharded_compute():
        ts = [torch.from_numpy(a) for a in args]
        if rules is not None:
            ts = [rules.distribute(t, ax) for t, ax in zip(ts, axes)]
        ts = [t.requires_grad_(True) for t in ts]
        flat = _flat(region(*ts))
        loss = sum((o * torch.from_numpy(g)).sum() for o, g in zip(flat, cots))
        grads = torch.autograd.grad(whole(loss), ts)
        local = [(o.to_local().detach().numpy(), str(o.placements)) if rules is not None
                 else None for o in flat]
    return {"out": _numpy(flat), "grads": _numpy(grads), "local": local}


# each region's arguments and cotangents in ``case_inputs``, and its split,
# restated from its ``over_batch`` call: the plain function, the positions
# of the weights (whole over the data axis), and the dim along which each
# argument and each output is taken local over 'model' (None: whole on
# every model rank)
REGION_NAMES = {"mlstm": (("q", "k", "v", "log_i", "f_pre", "c", "n", "m"),
                          ("gy", "gc", "gn", "gm")),
                "ssd": (("xs", "b_h", "c_h", "dt", "da"), ("gy", "gs")),
                "conv": (("x", "w", "bias"), ("g",)),
                "slstm": (("pre", "r_w", "c", "n", "m", "h"), ("gy", "gc", "gn", "gm", "gh"))}
REGION_SPLITS = {
    "mlstm": (lambda: functools.partial(txl._mlstm_scan, MLSTM["chunk"]), (),
              (None, None, 3, None, None, 2, None, None), (3, 2, None, None)),
    "ssd": (lambda: functools.partial(tssm._ssd_chunks, q=SSD["chunk"], d_state=SSD["n"]), (),
            (2, 2, 2, 2, 2), (2, 1)),
    "conv": (lambda: functools.partial(tssm._causal_conv, d_conv=CONV["d_conv"]), (1, 2),
             (2, 1, 0), (2,)),
}


def region_by_rank(region, data, grid=(2, 2)):
    """The 2×2 mesh's results of ``region`` built in one process, without
    rules, from a plain run of its function for each (data, model) rank on
    that rank's own block of the inputs: its batch rows (all rows of a
    weight) and its share along the dims split over 'model'. The outputs
    are placed where the ranks hold them; the gradients of split arguments
    too; those of an argument every model rank holds whole are summed over
    the model ranks, those of a weight over the data ranks (two parts: the
    same sum in either order). A whole output's cotangent enters on model
    rank 0 only, as ``over_batch`` counts it."""
    if region == "slstm":
        return _slstm_by_rank(data, grid)
    make, weights, arg_dims, out_dims = REGION_SPLITS[region]
    fn = make()
    names, cot_names = REGION_NAMES[region]
    args, cots = [data[n] for n in names], [data[g] for g in cot_names]
    dp, tp = grid

    def index(a, dc, mc, batch, dim):
        idx = [slice(None)] * a.ndim
        if batch:
            n = a.shape[0] // dp
            idx[0] = slice(dc * n, (dc + 1) * n)
        if dim is not None:
            n = a.shape[dim] // tp
            idx[dim] = slice(mc * n, (mc + 1) * n)
        return tuple(idx)

    outs = [np.zeros_like(g) for g in cots]
    grads = [np.zeros_like(a) for a in args]
    for dc in range(dp):
        for mc in range(tp):
            arg_idx = [index(a, dc, mc, i not in weights, d)
                       for i, (a, d) in enumerate(zip(args, arg_dims))]
            ts = [torch.from_numpy(np.ascontiguousarray(a[ix])).requires_grad_(True)
                  for a, ix in zip(args, arg_idx)]
            flat = _flat(fn(*ts))
            out_idx = [index(g, dc, mc, True, d) for g, d in zip(cots, out_dims)]
            cot = [torch.from_numpy(np.ascontiguousarray(g[ix])) if d is not None or mc == 0
                   else torch.zeros(g[ix].shape) for g, ix, d in zip(cots, out_idx, out_dims)]
            parts = torch.autograd.grad(flat, ts, cot)
            for o, whole_o, ix in zip(flat, outs, out_idx):
                whole_o[ix] = o.detach().numpy()
            for i, (g, ix) in enumerate(zip(parts, arg_idx)):
                summed = (i in weights) or arg_dims[i] is None
                assert not (i in weights and arg_dims[i] is None), "a sum of four parts"
                grads[i][ix] = grads[i][ix] + g.numpy() if summed else g.numpy()
    return {"out": outs, "grads": grads}


def _slstm_by_rank(data, grid):
    """``region_by_rank`` of the sLSTM (``xlstm._slstm_region``): for each
    data rank's rows, the model ranks' scans run in lockstep in one
    chunked scan, each model rank with its own copy of the whole state and
    r_w, its block of the gate pre-activations and of ``gate_rows``
    (``slstm_block_sums``, the same op as on its rank); each rank's
    update takes every block's gate sums concatenated in rank order (the
    all-gather), whose gradient is the sum of the ranks' parts (the
    reduce-scatter). Model rank 0's outputs are the outputs (every model
    rank computes the same; the cotangents enter on rank 0); the gradients
    of the whole state and of r_w are summed over the ranks (two parts at
    a time, or disjoint blocks), those of the pre-activations placed by
    block."""
    dp, tp = grid
    names, cot_names = REGION_NAMES["slstm"]
    (pre, r_w, *state), cots = [data[n] for n in names], [data[g] for g in cot_names]
    b, d = state[0].shape
    sdh, w = r_w.shape[1], pre.shape[2] // tp
    blocks = [txl.slstm_block(d, sdh, tp, m) for m in range(tp)]

    def leaf(a):
        return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True)

    def step(st, *args):
        states = [tuple(st[4 * m: 4 * m + 4]) for m in range(tp)]
        sums = [txl.slstm_block_sums(blocks[m], states[m][3], args[m], args[tp + m])
                for m in range(tp)]
        new, ys = [], []
        for m in range(tp):
            st_m, y = txl._slstm_cell(states[m], torch.cat(sums, dim=1))
            new.extend(st_m)
            ys.append(y)
        return tuple(new), ys[0]

    outs = [np.zeros_like(g) for g in cots]
    grads = [np.zeros_like(a) for a in (pre, r_w, *state)]
    for dc in range(dp):
        rows = slice(dc * b // dp, (dc + 1) * b // dp)
        pres = [leaf(pre[rows, :, m * w: (m + 1) * w]) for m in range(tp)]
        rws = [leaf(r_w) for _ in range(tp)]
        sts = [leaf(a[rows]) for _ in range(tp) for a in state]
        gate_rows = [txl.gate_rows(rws[m])[m * w: (m + 1) * w] for m in range(tp)]
        ys, final = chunked_scan(step, tuple(pres), tuple(gate_rows), tuple(sts),
                                  SLSTM["chunk"], (d,))
        flat = [ys, *final[:4]]
        parts = torch.autograd.grad(flat, pres + rws + sts,
                                    [torch.from_numpy(np.ascontiguousarray(g[rows]))
                                     for g in cots])
        for o, whole_o in zip(flat, outs):
            whole_o[rows] = o.detach().numpy()
        for m in range(tp):
            grads[0][rows, :, m * w: (m + 1) * w] = parts[m].numpy()
            grads[1] = grads[1] + parts[tp + m].numpy()
        for i in range(4):
            grads[2 + i][rows] = sum(parts[2 * tp + 4 * m + i].numpy() for m in range(tp))
    return {"out": outs, "grads": grads}


def _region_args(region, data):
    names, cot_names = REGION_NAMES[region]
    return [data[n] for n in names], [data[g] for g in cot_names]


def mlstm(data, rules=None):
    rows = ("batch", None, None, None)
    axes = (rows, rows, rows, rows[:3], rows[:3]) + txl.MLSTM_STATE_AXES
    args, cots = _region_args("mlstm", data)
    return _region_run(txl._mlstm_region(MLSTM["chunk"]), args, axes, cots, rules)


def ssd(data, rules=None):
    heads = ("batch", None, "ssm_heads", None)
    axes = (heads, ("batch", None, None, None), ("batch", None, None, None), heads[:3],
            heads[:3])
    args, cots = _region_args("ssd", data)
    return _region_run(tssm._ssd_region(SSD["chunk"], SSD["n"]), args, axes, cots, rules)


def conv(data, rules=None):
    axes = (("batch", None, None), (None, "conv_dim"), ("conv_dim",))
    args, cots = _region_args("conv", data)
    return _region_run(tssm._conv_region(CONV["d_conv"]), args, axes, cots, rules)


def slstm(data, rules=None):
    axes = (("batch", None, "ffn"), ("heads", None, None)) + (("batch", None),) * 4
    args, cots = _region_args("slstm", data)
    return _region_run(txl._slstm_region(SLSTM["chunk"]), args, axes, cots, rules)


def xlstm_prefill_decode(rules=None):
    """Reduced xLSTM-125M (block 0 an mLSTM, block 1 an sLSTM; f32): the
    prefill's last logits and every decode step's logits and greedy
    tokens, whole, as ``prefill_decode``."""
    cfg = get_config("xlstm-125m").reduced()
    assert cfg.slstm_layers == (1,)
    model = build_model(cfg)
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(DECODE_BATCH, PROMPT)))
    with f32(), use_rules(rules), sharded_compute():
        params = model.init(seed=0, device="cpu")
        if rules is not None:
            params = rules.place(params, model.param_axes())
            tokens = rules.distribute(tokens, ("batch", None))
        logits, cache = model.prefill(params, {"tokens": tokens}, MAX_SEQ)
        out = {"logits": [whole(logits).numpy()], "tokens": []}
        for _ in range(N_DECODE):
            tok = whole(logits).argmax(-1)[:, None]
            out["tokens"].append(tok.numpy())
            if rules is not None:
                tok = rules.distribute(tok, ("batch", None))
            logits, _ = model.decode_step(params, tok, cache)
            out["logits"].append(whole(logits).numpy())
    return out


def rank_main(rank, world, store, out_dir):
    torch.set_num_threads(1)
    warnings.filterwarnings("ignore")
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        rules = MeshRules.for_mesh(mesh)
        data = case_inputs()
        res = {"coords": (mesh.get_local_rank("data"), mesh.get_local_rank("model")),
               "decode": prefill_decode(rules),
               "mlstm": mlstm(data["mlstm"], rules), "ssd": ssd(data["ssd"], rules),
               "conv": conv(data["conv"], rules), "slstm": slstm(data["slstm"], rules),
               "xlstm_decode": xlstm_prefill_decode(rules)}
        for path in ATTN_PATHS:
            res[("attn", path)] = attention(path, data["attn"], rules)
            res[("core", path)] = attention_core(path, data["core"], rules)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        drain()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the fake (4, 4) mesh
# ---------------------------------------------------------------------------

FAKE_MESH = (4, 4)
# the prefills: batch 4 (one row a data rank) × 128 positions into a
# 256-position cache
PREFILL_ARCHS = ("olmoe-1b-7b", "zamba2-7b")
PREFILL = InputShape("prefill_256", 256, 4, "prefill")
PROMPT_FAKE = 128
# the attention: 6 heads (2 kv heads) over 4 model ranks, 128 positions,
# batch 4, direct path
FAKE_ATTN = dict(b=4, s=128, d=48, h=6, kv=2, hd=8)
# the xLSTM train step whose chunk count is checked: one mLSTM block at
# d_model 64 (dh 32, which the 4 model ranks divide), batch 4 × 128, two
# chunks of 64
XLSTM_TRAIN = InputShape("train_128", 128, 4, "train")
# the sLSTM region's forward at reduced xLSTM-125M's widths (d 256, 4 heads
# of 64): batch 4 (a row a data rank) × 32 steps, chunks of 8
FAKE_SLSTM = dict(b=4, s=32, chunk=8)
XLSTM_CUT = dict(n_layers=1, slstm_layers=(), d_model=64, head_dim=16)


def _largest_counter():
    from repro_torch.launch.cost_analysis import CostCounter

    class Largest(CostCounter):
        """Also keeps the largest new storage (bytes) and the largest f32
        one (elements)."""

        def __init__(self):
            super().__init__()
            self.largest = self.largest_f32 = 0

        def _add_storage(self, t):
            if t.untyped_storage() not in self._storages:
                n = t.untyped_storage().nbytes()
                self.largest = max(self.largest, n)
                if t.dtype == torch.float32:
                    self.largest_f32 = max(self.largest_f32, n // 4)
            super()._add_storage(t)

    return Largest()


def _fake_prefill(arch, rules):
    """The reduced ``arch``'s prefill on the fake mesh: each cache leaf's
    (whole bytes, local storage bytes, the ranks its placements divide it
    over), the largest allocation inside the prefill and the bytes of one
    layer's whole K cache (bf16)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.dryrun import build_step

    cfg = get_config(arch).reduced()
    with FakeTensorMode(), use_rules(rules):
        fn, (params, batch) = build_step(cfg, PREFILL, rules.mesh, rules, device="cpu")
        batch = {"tokens": batch["tokens"][:, :PROMPT_FAKE]}
        counter = _largest_counter()
        with counter:
            _, cache = fn(params, batch)
    leaves = []
    for path, leaf in tree_leaves(cache):
        for t in (leaf if isinstance(leaf, tuple) else (leaf,)):
            if isinstance(t, DTensor):
                ranks = 1
                for mesh_dim, p in enumerate(t.placements):
                    ranks *= rules.mesh.size(mesh_dim) if p.is_shard() else 1
                leaves.append((path, t.numel() * t.element_size(),
                               t.to_local().untyped_storage().nbytes(), ranks))
    kv = cfg.n_cache_kv_heads if arch != "zamba2-7b" else cfg.n_kv_heads
    layer_k = PREFILL.global_batch * PREFILL.seq_len * kv * cfg.resolved_head_dim * 2
    return {"leaves": leaves, "largest": counter.largest, "layer_k": layer_k}


def _fake_attention(rules):
    """The attention sublayer (6 heads over 4 model ranks, causal, direct
    path, f32) forward and backward: the largest f32 storage (elements)
    each allocates, and whether q's sequence is split over 'model'."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.dryrun import _placed_empty

    a = FAKE_ATTN
    shapes = {"wq": (a["d"], a["h"] * a["hd"]), "wk": (a["d"], a["kv"] * a["hd"]),
              "wv": (a["d"], a["kv"] * a["hd"]), "wo": (a["h"] * a["hd"], a["d"])}
    with FakeTensorMode(), use_rules(rules), sharded_compute():
        params = {n: _placed_empty(sh, torch.float32, BLOCK_AXES[n], rules, "cpu")
                  .requires_grad_(True) for n, sh in shapes.items()}
        x = _placed_empty((a["b"], a["s"], a["d"]), torch.float32, ("batch", None, "act_embed"),
                          rules, "cpu").requires_grad_(True)
        forward, backward = _largest_counter(), _largest_counter()
        with forward:
            out = tattn.multi_head_attention(x, params, a["h"], a["kv"], a["hd"])
        with backward:
            torch.autograd.grad(out.sum().full_tensor(), [x, *params.values()])
        seq_split = tattn._seq_on_model((a["b"], a["s"], a["h"], a["hd"]))
    return {"forward": forward.largest_f32, "backward": backward.largest_f32,
            "seq_split": seq_split}


def _fake_slstm(rules):
    """The sLSTM region's forward (``xlstm._slstm_region``) on fake tensors,
    placed as ``slstm_forward`` gets them under ``rules`` ("mesh": the gate
    pre-activations over 'model' by their 4d columns, r_w whole, the state
    whole over 'model') and on plain tensors ("one"): the CostCounter's
    summary of each (every step traced)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.cost_analysis import CostCounter

    f, d, h = FAKE_SLSTM, _X.d_model, _X.n_heads
    shapes = ((f["b"], f["s"], 4 * d), (h, d // h, 4 * d // h)) + ((f["b"], d),) * 4
    axes = (("batch", None, "ffn"), (None, None, None)) + (("batch", None),) * 4
    res = {}
    for name, r in (("mesh", rules), ("one", None)):
        with FakeTensorMode(), use_rules(r), sharded_compute():
            args = [rules.full(sh, ax, None, torch.float32, "cpu") if r is not None
                    else torch.empty(sh) for sh, ax in zip(shapes, axes)]
            counter = CostCounter()
            with counter:
                txl._slstm_region(f["chunk"])(*args)
        res[name] = counter.summary()
    return res


def _fake_dryrun(mesh, mode):
    """Reduced xLSTM-125M's train step on the fake mesh, one chunk counted
    for all (``mode`` "chunks") or every step traced ("steps"): the
    report."""
    from repro_torch.launch.dryrun import run_dryrun

    cfg = dataclasses.replace(get_config("xlstm-125m").reduced(), **XLSTM_CUT)
    return run_dryrun(cfg, XLSTM_TRAIN, mesh=mesh, verbose=False, device="cpu",
                      count_chunks=mode == "chunks")


def fake_main(mode, out_path):
    """``mode`` "fake": the prefills, the attention and the xLSTM dry run
    counting one chunk for all; "steps": that dry run tracing every step
    (in a process of its own, to run beside the other)."""
    from repro_torch.launch.mesh import make_dry_mesh

    torch.set_num_threads(1)
    warnings.filterwarnings("ignore")
    mesh = make_dry_mesh(FAKE_MESH, ("data", "model"), "cpu")
    if mode == "steps":
        res = _fake_dryrun(mesh, "steps")
    else:
        rules = MeshRules.for_mesh(mesh)
        res = {arch: _fake_prefill(arch, rules) for arch in PREFILL_ARCHS}
        res["attention"] = _fake_attention(rules)
        res["slstm"] = _fake_slstm(rules)
        res["chunks"] = _fake_dryrun(mesh, "chunks")
    dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    fake_main(sys.argv[1], sys.argv[2])
