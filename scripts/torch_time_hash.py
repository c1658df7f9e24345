#!/usr/bin/env python3
"""Time and count the fused hash kernel and the rule-only trust of one or
more trees of kbbq_tpu_torch on the card.

    python3 scripts/torch_time_hash.py [--reads 1533333] [--sass-dir DIR]
                                       ROOT [ROOT ...]

Each ROOT is a directory that holds a ``kbbq_tpu_torch`` package (a checkout
of this repository, or an unpacked ``git archive`` of another commit); each
is run in a process of its own, in the order given, so naming a tree twice
(parent, change, change, parent) shows the drift of the card.  Every tree
builds its own kernels.  Per tree one JSON line:

- the four entry points of the two kernels on chip_smoke.py's main-path data
  (config 2: 1,533,333 reads of 150 bases at 50x, k = 32): ``hash_build``
  (the hash cache and filter A of every window), ``hash_keep`` (the same
  planes, no filter), ``hash_only`` (one streamed window of 131,072 reads,
  and checked on every window) and ``trust_rule`` (the rule on filter A's
  hits of every window), each held to its plain version first (mismatches)
  and timed two ways: ``ms``, CUDA events around one call (the build into a
  zeroed filter), and ``graph_ms``, one launch out of a CUDA graph of five
  (the build into the same filter again);
- ``walk_start``, which packs with the hash kernel's helper: ``graph_ms``
  on chip_smoke.py's walk chunk (65,536 reads), checked there;
- the SASS of each kernel instance of those entry points (``cuobjdump
  -sass`` of the tree's library): instructions by class and each loop (a
  backward branch: its range, instructions by class, whether it stores),
  and the registers ``-Xptxas -v`` reported.  The full listing of those
  functions goes to ``DIR/<i>_sass.txt`` and the whole record to
  ``DIR/<i>_time_hash.json`` (i: the tree's place in the arguments;
  ``--sass-dir``, default ``time_hash_out``); stdout counts the loops
  only.

Instruction classes, after the H100's issue ports: ``alu`` the integer ALU
pipe (IADD3, LOP3, SHF, ISETP, LEA, SEL, PRMT, POPC, BREV, FLO, ...), 64
lanes an SM, ``fma`` the FMA pipe (IMAD and the float ops), ``mem`` loads,
stores and atomics, ``warp`` votes, shuffles and barriers, ``uniform`` the
warp-uniform datapath (U* opcodes, not issued per lane), ``control``
branches, and ``other``.  The split is by opcode name only.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

ALU = {"IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "ISETP", "LEA",
       "SEL", "PRMT", "POPC", "BREV", "FLO", "IMNMX", "IABS", "SGXT", "BMSK",
       "PLOP3", "ICMP", "BFE", "BFI", "IDP", "VABSDIFF", "VIADD", "VIMNMX"}
FMA = {"IMAD", "IMUL", "FFMA", "FMUL", "FADD", "FSEL", "FSETP", "FMNMX",
       "HFMA2", "IMADSP", "I2F", "F2I"}
MEM = {"LDG", "STG", "LDS", "STS", "LD", "ST", "LDC", "ATOM", "ATOMG",
       "ATOMS", "RED", "REDG", "LDL", "STL", "LDSM", "CCTL"}
WARP = {"SHFL", "VOTE", "MATCH", "REDUX", "BAR", "WARPSYNC", "NANOSLEEP",
        "MEMBAR", "ERRBAR", "DEPBAR"}
CONTROL = {"BRA", "BRX", "EXIT", "BSSY", "BSYNC", "CALL", "RET", "BMOV",
           "NOP", "YIELD", "BPT", "JMP", "WARPSYNC.ALL"}
# the kernels of the four entry points, by a piece of their mangled names
KERNELS = ("hash_build_kernel", "trust_rule_kernel",
           "bloom_probe_trust_kernel", "walk_start_kernel")


def _chip_smoke():
    """This checkout's chip_smoke.py, for its timing helpers: loaded by
    path, whatever tree is timed."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def op_class(op: str) -> str:
    base = op.split(".")[0]
    if base.startswith("U") and base not in ("UNKNOWN",):
        return "uniform"
    for name, group in (("alu", ALU), ("fma", FMA), ("mem", MEM),
                        ("warp", WARP), ("control", CONTROL)):
        if base in group:
            return name
    return "other"


def parse_sass(text: str) -> dict:
    """{function name: [(address, opcode, text)]} of a cuobjdump listing,
    branch labels resolved to addresses in the text."""
    funcs, cur, labels = {}, None, {}
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        if cur is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            labels[(id(cur), m.group(1))] = len(cur)
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            body = m.group(2)
            toks = body.split()
            if toks and toks[0].startswith("@"):
                toks = toks[1:]
            if toks:
                cur.append([int(m.group(1), 16), toks[0], body])
    # labels -> the address of the instruction that follows them
    for name, ins in funcs.items():
        for (fid, label), idx in labels.items():
            if fid == id(ins) and idx < len(ins):
                for row in ins:
                    row[2] = row[2].replace(f"`({label})",
                                            hex(ins[idx][0]))
    return funcs


def summarise(ins: list) -> dict:
    by = {}
    for _, op, _ in ins:
        c = op_class(op)
        by[c] = by.get(c, 0) + 1
    loops = []
    for addr, op, body in ins:
        if not op.startswith("BRA"):
            continue
        m = re.search(r"0x([0-9a-f]+)", body)
        if not m:
            continue
        target = int(m.group(1), 16)
        if target >= addr:
            continue
        seg = [r for r in ins if target <= r[0] <= addr]
        cls = {}
        for _, o, _ in seg:
            c = op_class(o)
            cls[c] = cls.get(c, 0) + 1
        loops.append({"from": hex(target), "to": hex(addr),
                      "instructions": len(seg), "by_class": cls,
                      "stores": sum(o.startswith(("STG", "ST."))
                                    for _, o, _ in seg),
                      "atomics": sum(o.startswith(("RED", "ATOM"))
                                     for _, o, _ in seg)})
    return {"instructions": len(ins), "by_class": by, "loops": loops}


def sass_of(lib_path: str, out_path: str) -> dict:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    funcs = parse_sass(text)
    keep = {name: ins for name, ins in funcs.items()
            if any(k in name for k in KERNELS)}
    with open(out_path, "w") as f:
        for name, ins in keep.items():
            f.write(f"Function : {name}\n")
            for addr, _, body in ins:
                f.write(f"  /*{addr:04x}*/ {body}\n")
    return {name: summarise(ins) for name, ins in keep.items()}


def time_tree(root: str, reads: int, sass_path: str,
              extra_log2_m=(), read_len: int = 150) -> dict:
    sys.path.insert(0, root)
    smoke = _chip_smoke()
    import numpy as np
    import torch
    from kbbq_tpu_torch import kernels
    from kbbq_tpu_torch.ops import bloom as tb
    from kbbq_tpu_torch.ops.hash_cache import (hash_cache_chunk,
                                               hash_windows_plain)
    from kbbq_tpu_torch.ops.trusted import trusted_mask_batch
    from kbbq_tpu_torch.oracle import (alpha_threshold, bloom_params_for,
                                       coverage_thresholds)
    from kbbq_tpu_torch.pipeline import RecalConfig
    from kbbq_tpu_torch.utils.synth import make_arrays_fast

    shutil.rmtree(kernels.BUILD_DIR, ignore_errors=True)
    lib_path = kernels.build()
    regs = [ln.strip() for ln in kernels.build_log.splitlines()
            if "registers" in ln or "Compiling entry" in ln]
    sass = sass_of(lib_path, sass_path)

    dev = torch.device("cuda")
    cfg = RecalConfig(k=32, coverage=50.0)
    k, h = cfg.k, cfg.num_hashes
    arrays, _ = make_arrays_fast(genome_len=4_600_000, read_len=read_len,
                                 num_reads=reads, error_rate=0.005, seed=0,
                                 paired=True)
    N, L = arrays.codes.shape
    n = L - k + 1
    alpha, coverage = cfg.resolve_alpha(N * L)
    pa, _ = bloom_params_for(cfg, N * n, alpha, coverage)
    thr = int(alpha_threshold(alpha))
    codes = torch.from_numpy(arrays.codes).to(dev)
    rows = 65536

    # the plain hash pass and build A, the spec of all three modes
    p1 = torch.empty((N, n), dtype=torch.int32, device=dev)
    pw, pk = torch.empty_like(p1), torch.empty((N, n), dtype=torch.bool,
                                                device=dev)
    for s in range(0, N, rows):
        e = min(N, s + rows)
        ids = torch.arange(s, e, dtype=torch.int64, device=dev)
        p1[s:e], pw[s:e], pk[s:e] = hash_cache_chunk(codes[s:e], ids, k, h,
                                                     thr)
    plain_a = tb.bloom_build_words_plain(p1, pw, pk, pa.log2_m)

    def mm(a, b):
        return int((a != b).sum().item())

    out = {"root": root, "reads": N, "windows": N * n,
           "card": torch.cuda.get_device_name(0), "smi": smoke.smi_line(),
           "registers": regs, "sass": sass}
    filt = torch.zeros(1 << (pa.log2_m - 5), dtype=torch.int32, device=dev)
    h1, word, keep = kernels.hash_build(codes, filt, 0, k, h, thr)
    out["hash_build"] = {
        "mismatches": mm(h1, p1) + mm(word, pw) + mm(keep, pk)
        + mm(filt, plain_a),
        "ms": smoke.cuda_ms(lambda: kernels.hash_build(codes, filt, 0, k, h,
                                                       thr),
                            before=filt.zero_),
        "graph_ms": smoke.cuda_graph_ms(
            lambda: kernels.hash_build(codes, filt, 0, k, h, thr),
            launches=5)}
    del h1, word, keep
    # the same build into smaller filters (2^26 bits, 8 MiB, stays in L2)
    for log2_m in extra_log2_m:
        small = torch.zeros(1 << (log2_m - 5), dtype=torch.int32, device=dev)
        got = kernels.hash_build(codes, small, 0, k, h, thr)
        out[f"hash_build_2^{log2_m}"] = {
            "mismatches": mm(small, tb.bloom_build_words_plain(
                p1, pw, pk, log2_m)) + mm(got[0], p1),
            "ms": smoke.cuda_ms(lambda: kernels.hash_build(
                codes, small, 0, k, h, thr), before=small.zero_),
            "graph_ms": smoke.cuda_graph_ms(
                lambda: kernels.hash_build(codes, small, 0, k, h, thr),
                launches=5)}
        del got, small
    got = kernels.hash_keep(codes, 0, k, h, thr)
    out["hash_keep"] = {
        "mismatches": sum(mm(a, b) for a, b in zip(got, (p1, pw, pk))),
        "ms": smoke.cuda_ms(lambda: kernels.hash_keep(codes, 0, k, h, thr)),
        "graph_ms": smoke.cuda_graph_ms(
            lambda: kernels.hash_keep(codes, 0, k, h, thr), launches=5)}
    del got
    got = kernels.hash_only(codes, k, h)
    cw = codes[:131_072]
    wh1, wword = hash_windows_plain(cw, k, h)
    out["hash_only"] = {
        "mismatches": mm(got[0], p1) + mm(got[1], pw)
        + sum(mm(a, b) for a, b in zip(kernels.hash_only(cw, k, h),
                                       (wh1, wword))),
        "window_reads": int(cw.shape[0]),
        "ms": smoke.cuda_ms(lambda: kernels.hash_only(cw, k, h)),
        "graph_ms": smoke.cuda_graph_ms(lambda: kernels.hash_only(cw, k, h),
                                        launches=5)}
    del got, wh1, wword
    hits = tb.bloom_query_words(plain_a, p1, pw)
    t_table = torch.from_numpy(
        coverage_thresholds(alpha, k).astype(np.int32)).to(dev)
    T = k if cfg.trust_threshold is None else cfg.trust_threshold
    trusted = kernels.trust_rule(hits, pw, t_table, k, T)
    bad = 0
    for s in range(0, N, rows):
        e = min(N, s + rows)
        bad += mm(trusted[s:e], trusted_mask_batch(hits[s:e], pw[s:e] != 0,
                                                   t_table, k, T))
    low = kernels.trust_rule(hits, pw, t_table, k, k - 12)
    for s in range(0, N, rows):
        e = min(N, s + rows)
        bad += mm(low[s:e], trusted_mask_batch(hits[s:e], pw[s:e] != 0,
                                               t_table, k, k - 12))
    res = torch.empty_like(trusted)
    out["trust_rule"] = {
        "mismatches": bad, "trusted": int(trusted.sum()),
        "ms": smoke.cuda_ms(lambda: kernels.trust_rule(hits, pw, t_table, k,
                                                       T, out=res)),
        "graph_ms": smoke.cuda_graph_ms(
            lambda: kernels.trust_rule(hits, pw, t_table, k, T, out=res),
            launches=5)}
    # walk_start packs the walk's working copy with the hash kernel's
    # pack_chunk: its time on chip_smoke.py's walk chunk and lane groups,
    # with the rule's trusted bytes as the initial trust
    from kbbq_tpu_torch.parallel.sharded_bloom import EXCHANGE_CHUNK
    wr = min(smoke.WALK_READS, N)
    G = max(1, EXCHANGE_CHUNK // (3 * k))
    out["walk_start"] = {"reads": wr, "graph_ms": smoke.cuda_graph_ms(
        lambda: kernels.walk_start(codes[:wr], trusted[:wr], k, G))}
    out["launches"] = dict(kernels.ENTRY_LAUNCHES)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--reads", type=int, default=1_533_333)
    ap.add_argument("--sass-dir", default="time_hash_out")
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--log2-m", default="",
                    help="comma-separated log2 bits of more filters to "
                         "time hash_build against")
    ap.add_argument("--one", type=int, default=-1, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one >= 0:
        stem = os.path.join(args.sass_dir, f"{args.one}")
        res = time_tree(args.roots[0], args.reads, f"{stem}_sass.txt",
                        [int(x) for x in args.log2_m.split(",") if x],
                        args.read_len)
        with open(f"{stem}_time_hash.json", "w") as f:
            json.dump(res, f, indent=1)
        # on stdout without the loops (they are in the file)
        for fn in res["sass"].values():
            fn["loops"] = len(fn["loops"])
        print(json.dumps(res), flush=True)
        return 0
    os.makedirs(args.sass_dir, exist_ok=True)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    print(_chip_smoke().smi_line(), flush=True)
    failed = []
    for i, root in enumerate(args.roots):
        rc = subprocess.run([sys.executable, __file__, "--one", str(i),
                             "--reads", str(args.reads), "--sass-dir",
                             os.path.abspath(args.sass_dir), "--log2-m",
                             args.log2_m, "--read-len", str(args.read_len),
                             root]).returncode
        if rc:
            failed.append(root)
            print(f"{root}: exit {rc}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
