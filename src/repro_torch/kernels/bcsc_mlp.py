"""Fused block-CSC MLP: ``act(x·Wg) [* (x·Wu)] · Wd`` in one launch.

Counterpart of ``repro.kernels.bcsc_mlp``. The three projections are packed
BCSC weights (see ``bcsc_matmul``) padded to a shared capacity; ``counts``
(3,) int32 = [n_g, n_u, n_d] holds each layer's real block count, and blocks
at or past it are pads that are skipped. The hidden is rounded to bf16
before the down-projection, as the reference's two-call path rounds it.

``bcsc_mlp_plain`` takes the dense product over the decoded weights;
``bcsc_mlp_cuda`` launches ``csrc/bcsc_mlp.cu``: one cooperative launch of
``mlp_plan``'s grid (every thread block resident), whose warps each stream
their blocks through a cp.async ring onto the tensor cores with the rows as
the MMA's N. Phase 1 gives each pair of warps whole hidden block-columns
(gate and up, the column's blocks cut in two halves); after a grid
barrier, phase 2 cuts each output block-column's down-projection segment
into ``split`` parts, one a warp, and the last part to finish adds the
parts' partials in split order. ``schedule_model`` computes the same
schedule in plain torch for the CPU tests.

The cooperative launch captures into a CUDA graph as it is (the decode
step's ``serve.graphs.StepGraph``): its occupancy queries run once, at
capture, and the barrier's words re-arm at every replay as at every call.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bcsc_matmul import _check, _dense_weight
from repro_torch.kernels.epilogue import act_code, fused_epilogue

MLP_WARPS = 16           # warps of a thread block (kMlpWarps)
MLP_BLOCKS_PER_SM = 1    # resident thread blocks an SM (kMlpBlocksPerSm)
MIN_SPLIT_ROWS = 8       # hidden block-rows a phase-2 part covers at least
MAX_ROWS = 64            # rows of one launch; more go in launches of 64


def row_tiles(Mp: int) -> int:
    """8-row MMA tiles the kernel instantiates for Mp rows: 1, 2, 4 or 8."""
    return 1 if Mp <= 8 else 2 if Mp <= 16 else 4 if Mp <= 32 else 8


def ring_stages(nt: int) -> int:
    """Blocks in flight in a warp's ring (``WalkRing<NT>::kStages`` in
    ``csrc/common.cuh``): about 12 KB of ring a warp, slots of 512 weight
    bytes and nt * 8 rows of 32 bytes."""
    return {1: 16, 2: 12, 4: 8, 8: 4}[nt]


def mlp_plan(d_ff: int, n_out: int, n_sm: int) -> dict:
    """The launch of one call, from shapes and the SM count only: the grid
    (MLP_BLOCKS_PER_SM thread blocks an SM, all resident), its warps, and
    the phase-2 split: the most parts per output block-column that still
    give every part its own warp, each part at least MIN_SPLIT_ROWS
    hidden block-rows on average."""
    grid = MLP_BLOCKS_PER_SM * n_sm
    warps = grid * MLP_WARPS
    n_cols = n_out // 16
    split = max(1, min(warps // n_cols, (d_ff // 16) // MIN_SPLIT_ROWS))
    return {"grid": grid, "warps": warps, "split": split}


def launch_config(Mp: int, d_ff: int, n_out: int, n_sm: int) -> dict:
    """What ``bcsc_mlp_cuda`` launches for Mp rows (<= MAX_ROWS)."""
    plan = mlp_plan(d_ff, n_out, n_sm)
    nt = row_tiles(Mp)
    slot = 512 + nt * 8 * 32
    return dict(plan, threads=32 * MLP_WARPS, row_tiles=nt,
                stages=ring_stages(nt),
                smem_bytes=MLP_WARPS * slot * ring_stages(nt),
                phase1_columns=d_ff // 16,
                phase1_pairs=plan["warps"] // 2,
                phase2_tasks=(n_out // 16) * plan["split"])


def bcsc_mlp_plain(x, gate, up, down, counts, *, d_ff: int, n_out: int,
                   activation: Optional[str] = None):
    """x (M, K) bf16; gate/up/down are (blocks, row_ids, col_ids) triples
    (``up`` None for an ungated MLP); counts (3,). Returns (M, n_out) fp32."""
    K = x.shape[1]
    n = [int(c) for c in counts.tolist()]

    def dense(pack, count, k_in, n_cols):
        blocks, rows, cols = pack
        return _dense_weight(blocks[:count], rows[:count], cols[:count],
                             k_in, n_cols)

    xf = x.float()
    h = fused_epilogue(xf @ dense(gate, n[0], K, d_ff), None, activation)
    if up is not None:
        h = h * (xf @ dense(up, n[1], K, d_ff))
    h = h.to(torch.bfloat16).float()
    return h @ dense(down, n[2], d_ff, n_out)


def schedule_model(x, gate, up, down, counts, *, d_ff: int, n_out: int,
                   activation: Optional[str] = None, n_sm: int = 132):
    """The kernel's schedule in plain torch, fp32: gate/up/down are
    (blocks, row_ids, col_ptr) triples, x (Mp, K) with Mp <= MAX_ROWS.

    Phase 1: the pair of warps p (numbered across thread blocks first)
    owns hidden block-columns p, p + pairs, ...; a column's items, its gate
    blocks then its up blocks (each segment cut at counts), are cut in two
    halves, each walked block by block into a gate and an up sum, and the
    second half's sums are added to the first's; act(g) * u rounds to the
    bf16 hidden. Phase 2: task c * split + s (output block-column c, part s
    of its segment cut into ``split`` parts of equal block counts) goes to
    warp c * split + s; the partials are added in split order. Returns
    (out, trace): ``trace`` holds how often each payload block was read,
    per pack, the owner pair of each hidden column and the tasks of each
    warp."""
    Mp = x.shape[0]
    plan = mlp_plan(d_ff, n_out, n_sm)
    warps, split = plan["warps"], plan["split"]
    pairs = warps // 2
    n = [int(c) for c in counts.tolist()]
    packs = {"gate": gate, "up": up, "down": down}
    reads = {k: [0] * p[0].shape[0] for k, p in packs.items() if p is not None}
    xf = x.float()

    def items(name, c, count):
        """(pack, block index) of the column's segment, cut at count."""
        ptr = packs[name][2]
        hi = min(int(ptr[c + 1]), count)
        return [(name, i) for i in range(min(int(ptr[c]), hi), hi)]

    def walk(todo, src):
        """Sums of src's block-row slices times the blocks, by pack."""
        acc = {"gate": torch.zeros(Mp, 16), "up": torch.zeros(Mp, 16),
               "down": torch.zeros(Mp, 16)}
        for name, i in todo:
            blocks, rows, _ = packs[name]
            r = int(rows[i])
            acc[name] += src[:, 16 * r:16 * (r + 1)] @ blocks[i].float()
            reads[name][i] += 1
        return acc

    hidden = torch.empty(Mp, d_ff)
    owner = {}
    for p in range(pairs):
        for c in range(p, d_ff // 16, pairs):
            owner[c] = p
            todo = items("gate", c, n[0])
            if up is not None:
                todo += items("up", c, n[1])
            first = walk(todo[:len(todo) // 2], xf)
            second = walk(todo[len(todo) // 2:], xf)
            h = fused_epilogue(first["gate"] + second["gate"], None,
                               activation)
            if up is not None:
                h = h * (first["up"] + second["up"])
            hidden[:, 16 * c:16 * (c + 1)] = h
    hidden = hidden.to(torch.bfloat16).float()

    out = torch.empty(Mp, n_out)
    tasks = {}
    for c in range(n_out // 16):
        seg = items("down", c, n[2])
        total = torch.zeros(Mp, 16)
        for s in range(split):              # split order
            tasks.setdefault((c * split + s) % warps, []).append((c, s))
            part = seg[len(seg) * s // split:len(seg) * (s + 1) // split]
            total = total + walk(part, hidden)["down"]
        out[:, 16 * c:16 * (c + 1)] = total
    return out, {"reads": reads, "owner": owner, "tasks": tasks}


def bcsc_mlp_cuda(x, gate, up, down, counts, *, d_ff: int, n_out: int,
                  activation: Optional[str] = None):
    """The same function on the card. gate/up/down are (blocks, row_ids,
    col_ptr) triples; x (Mp, K) bf16 with Mp % 8 == 0. Up to MAX_ROWS rows
    take one launch, more take one per MAX_ROWS rows."""
    _check("x", x, torch.bfloat16)
    _check("counts", counts, torch.int32)
    Mp, K = x.shape
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    if Mp % 8 or K % 16 or d_ff % 16 or n_out % 16:
        raise ValueError(f"x {tuple(x.shape)}, d_ff {d_ff}, n_out {n_out}: "
                         "rows must divide by 8, widths by 16")
    packs = [gate, up, down]
    for name, pack, n_cols in (("gate", gate, d_ff), ("up", up, d_ff),
                               ("down", down, n_out)):
        if pack is None:
            continue
        blocks, rows, col_ptr = pack
        _check(f"{name} blocks", blocks, torch.bfloat16)
        _check(f"{name} row_ids", rows, torch.int32)
        _check(f"{name} col_ptr", col_ptr, torch.int32)
        if tuple(blocks.shape[1:]) != (16, 16) \
                or col_ptr.numel() != n_cols // 16 + 1:
            raise ValueError(f"{name}: 16 x 16 blocks and {n_cols // 16 + 1}"
                             " segment starts expected")
    ptrs = []
    for pack in packs:
        ptrs += [None] * 3 if pack is None else [t.data_ptr() for t in pack]
    plan = mlp_plan(d_ff, n_out, _build.sm_count(x.device.index or 0))
    split = plan["split"]
    stream = _build.stream_of(x)
    words = _build.sync_words(x, 2 + n_out // 16, stream)
    out = torch.empty((Mp, n_out), dtype=torch.float32, device=x.device)
    lib = _build.library()
    for m0 in range(0, Mp, MAX_ROWS):      # rows m0.. of x and out
        rows = min(MAX_ROWS, Mp - m0)
        hidden = torch.empty((rows, d_ff), dtype=torch.bfloat16,
                             device=x.device)
        ws = torch.empty((n_out // 16) * split * row_tiles(rows) * 128,
                         dtype=torch.float32,
                         device=x.device) if split > 1 else None
        code = lib.repro_bcsc_mlp(
            x.data_ptr() + 2 * m0 * K, rows, K, *ptrs, counts.data_ptr(),
            act_code(activation), d_ff, n_out, hidden.data_ptr(),
            out.data_ptr() + 4 * m0 * n_out, _build.ptr(ws),
            words.data_ptr(), plan["grid"], split, stream)
        _build.check(code, "bcsc_mlp")
        bcsc_mlp_cuda.launches += 1
    return out


bcsc_mlp_cuda.launches = 0
