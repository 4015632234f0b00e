#!/usr/bin/env python3
"""The traced K-dopri5 and K-events instances of one checkout on one NVIDIA
GPU, for a comparison of two versions of them on one card.

    python3 traced_ab.py [--tree DIR] [--handwritten] --out FILE
    python3 traced_ab.py --compare FILE FILE [FILE ...]

A run times and checks the instances with this checkout's ``chip_smoke.py``
(loaded before DIR goes on the path) and the package of DIR (default: this
checkout; a `git archive` of an earlier commit, say), building DIR's
instances into DIR's build directory:

1. ``chip_smoke._ex_traced`` and ``_phase_traced16``: phase 17 (a), float32
   and float64 on examples/ensemble.py at B=1024, and phase 18 (b),
   bfloat16 and float16 at B=1024 and 65536, each against its plain version
   under its phase's gates, with its device time alone
   (``chip_smoke._device_ms``);
2. each instance once more on those phases' B=1024 inputs: its outputs and
   counters, kept for ``--compare``;
3. what each instance's compiled step loop holds, from ``cuobjdump -sass``
   of its library (the tool beside nvcc): the loop is the kernel's
   outermost backward branch, and counted between the branch's target and
   the branch are its instructions, its shared-memory loads (LDS), its
   branches (BRA), its calls (CALL: the slow paths of the IEEE divide and
   square root) and its floating-point instructions; beside them the
   registers and spills ptxas gave the kernel;
4. with ``--handwritten``, a hash of the SASS of every hand-written
   K-dopri5 and K-events instance in DIR's kernel library (built at first
   use), so that ``--compare`` shows whether their compiled code moved.

It prints one JSON line beside the card's name and power limit and saves it,
with the outputs, to FILE (``torch.save``).  ``--compare`` holds every
output and counter of each file to the first file's bit for bit (NaN to
NaN) and prints each instance's device time, slowest lane and step loop
side by side.  Run versions in turns in one call (A, B, B, A): two calls
may land on two cards.
"""
import hashlib
import importlib
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FLOAT_OPS = ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FCHK", "FRND",
             "MUFU", "DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "F2F", "F2FP",
             "F2I", "I2F", "HADD2", "HMUL2", "HFMA2", "HSETP2", "HMNMX2")
KERNELS = ("dopri5_integrate_batched", "dopri5_events_batched")


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _functions(sass):
    """{mangled name: [(address, opcode, text)]} of a `cuobjdump -sass`
    listing."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and name:
            text = m.group(2)
            op = re.sub(r"^@!?U?P[T0-9]+\s+", "", text).split()[0]
            out[name].append((int(m.group(1), 16), op, text))
    return out


def step_loop(instrs):
    """What the step loop of a kernel holds: the outermost backward branch
    (the largest span from its target to itself) and the instructions
    between."""
    best = None
    for addr, op, text in instrs:
        m = re.search(r"0x([0-9a-f]+)\s*$", text)
        if op.startswith("BRA") and m:
            target = int(m.group(1), 16)
            if target < addr and (best is None
                                  or addr - target > best[1] - best[0]):
                best = (target, addr)
    if best is None:
        return None
    body = [op for addr, op, _ in instrs if best[0] <= addr <= best[1]]
    base = [op.split(".")[0] for op in body]
    return dict(instructions=len(body),
                lds=sum(b == "LDS" for b in base),
                bra=sum(b == "BRA" for b in base),
                call=sum(b == "CALL" for b in base),
                float=sum(b in FLOAT_OPS for b in base),
                all_lds=sum(op.split(".")[0] == "LDS" for _, op, _ in instrs),
                all_instructions=len(instrs))


def _cuobjdump(build):
    return str(Path(build._nvcc()).parent / "cuobjdump")


def traced_sass(build, so_path):
    """The step loop and ptxas registers of the one traced kernel in the
    library at `so_path`."""
    sass = subprocess.run([_cuobjdump(build), "-sass", so_path],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    funcs = {k: v for k, v in _functions(sass).items()
             if "traced_kernel" in k}
    (name, instrs), = funcs.items()
    loop = step_loop(instrs)
    log = Path(so_path).with_suffix(".log")
    regs = spills = None
    if log.exists():
        cur = None
        for line in log.read_text().splitlines():
            m = re.search(r"(?:entry function|Function properties for) "
                          r"'?(\w+)", line)
            if m:
                cur = m.group(1)
            if cur and "traced_kernel" in cur:
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    regs = int(m.group(1))
                m = re.search(r"(\d+) bytes spill stores", line)
                if m:
                    spills = int(m.group(1))
    return dict(loop=loop, registers=regs, spill_stores=spills)


def handwritten_sass(build):
    """A hash of the SASS of each hand-written K-dopri5 and K-events
    instance (lanes_kernel, lanes_wide_kernel, events_kernel,
    events_wide_kernel) in the kernel library."""
    build.library()
    sass = subprocess.run([_cuobjdump(build), "-sass",
                           build.build_info["path"]], capture_output=True,
                          text=True, timeout=600, check=True).stdout
    out = {}
    for name, instrs in _functions(sass).items():
        if re.search(r"(lanes|events)(_wide)?_kernelI", name):
            text = "\n".join(t for _, _, t in instrs)
            out[name] = hashlib.sha256(text.encode()).hexdigest()[:16]
    return out


def _problems(torch, cs, dev, dtype):
    """Phase 17 (a)'s (float32, float64) or 18 (b)'s (16-bit) B=1024 inputs
    of the two instances: (field, y0 lanes-major, t1, lanes kwargs, event,
    events kwargs)."""
    from torchdiffeq_tpu_torch.examples import ensemble
    from torchdiffeq_tpu_torch.ops import traced
    low = dtype in (torch.bfloat16, torch.float16)
    omega, y0, t = ensemble.make_problem(cs.B if low else cs.ENS_B, dev,
                                         dtype)
    if dtype == torch.float16:
        rng = np.random.RandomState(0)
        omega = torch.from_numpy(np.exp(rng.uniform(
            *np.log(cs.TR16_OMEGA_F16), cs.B))).to(dev, dtype)
    y0T = y0.T.contiguous()
    field = traced.PerSampleField(ensemble.field, (omega,), (-1,))
    event = traced.PerSampleEvent(ensemble.event_fn)
    sign0 = torch.sign(y0T[:1]).contiguous()
    if low:
        t1 = 2.0 if dtype == torch.bfloat16 else cs.TR16_T_F16
        tol = dict(rtol=cs.LANE16_RTOL, atol=cs.LANE16_ATOL,
                   max_steps=cs.TR16_MAX_STEPS)
        kw = dict(tol, ts=np.linspace(0.0, t1, 5))
    else:
        t1 = 2.0
        tol = dict(rtol=cs.ENS_RTOL, atol=cs.ENS_RTOL * 1e-2)
        kw = dict(tol, ts=t.numpy())
    return field, y0T, t1, kw, event, dict(tol, ev_params=(sign0,))


def run(tree, out, handwritten):
    import torch
    import chip_smoke as cs   # this checkout's harness
    sys.path.insert(0, str(tree))
    from torchdiffeq_tpu_torch.ops import _build, kernels
    pkg = Path(kernels.__file__).resolve()
    assert tree in pkg.parents, f"the package came from {pkg}, not {tree}"
    dev = torch.device("cuda")
    card = _card()
    print(f"[traced_ab] {card} | tree {tree}", flush=True)
    entries = cs._ex_traced(torch, kernels, dev, math.nan, card)
    entries += cs._phase_traced16(torch, kernels, dev, card)
    device = {}
    for e in entries:
        base = e["name"].replace("_traced", "")
        if "[" in base:
            device[base] = dict(device_ms=e["device_ms"],
                                device_ms_65536=e["device_ms_65536"])
        else:
            device[base + "[f32]"] = dict(device_ms=e["device_ms"])
            device[base + "[f64]"] = dict(device_ms=e["device_ms_f64"])
    outputs, report = {}, {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64"),
                       (torch.bfloat16, "bf16"), (torch.float16, "f16")):
        field, y0T, t1, kw, event, ekw = _problems(torch, cs, dev, dtype)
        with torch.no_grad():
            runs = {
                KERNELS[0]: (kernels._lanes_launch(field, y0T, 0.0, t1, **kw)),
                KERNELS[1]: (kernels._events_launch(field, y0T, 0.0, event,
                                                    **ekw))}
            for name, (launch, outs) in runs.items():
                launch()
                torch.cuda.synchronize()
                key = f"{name}[{tag}]"
                outputs[key] = [o.detach().cpu().clone() for o in outs]
                worst = int(outs[-1].max())
                so = _build.traced_library(launch.source.source)._name
                rep = dict(device.get(key, {}), max_lane_steps=worst,
                           sass=traced_sass(_build, so))
                if "device_ms" in rep:
                    rep["ns_per_step"] = rep["device_ms"] * 1e6 / worst
                report[key] = rep
    line = dict(card=card, tree=str(tree), instances=report)
    if handwritten:
        line["handwritten_sass"] = handwritten_sass(_build)
    print(json.dumps(line), flush=True)
    torch.save(dict(line=line, outputs=outputs), out)
    return 0


def _bits(x):
    import torch
    ints = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.int8}
    return x.contiguous().view(ints[x.element_size()])


def compare(files):
    import torch
    loaded = [torch.load(f, weights_only=False) for f in files]
    first = loaded[0]
    print(f"[traced_ab compare] {first['line']['card']} | "
          + " | ".join(f"{f}: {d['line']['tree']}"
                       for f, d in zip(files, loaded)))
    same_all = True
    for key, outs in first["outputs"].items():
        cells = []
        for d in loaded[1:]:
            other = d["outputs"][key]
            same = all(torch.equal(_bits(a), _bits(b))
                       for a, b in zip(outs, other))
            differ = sum(int((_bits(a) != _bits(b)).sum())
                         for a, b in zip(outs, other))
            same_all &= same
            cells.append("bit for bit" if same else f"{differ} differ")
        rows = []
        for f, d in zip(files, loaded):
            r = d["line"]["instances"][key]
            loop = r["sass"]["loop"] or {}
            rows.append(
                f"{Path(f).name}: device {r.get('device_ms', math.nan):.4f} ms"
                + (f" (65536: {r['device_ms_65536']:.4f})"
                   if "device_ms_65536" in r else "")
                + f", slowest lane {r['max_lane_steps']} steps, "
                f"{r.get('ns_per_step', math.nan):.1f} ns a step, loop "
                f"{loop.get('instructions')} instr / LDS {loop.get('lds')} / "
                f"BRA {loop.get('bra')} / CALL {loop.get('call')} / float "
                f"{loop.get('float')}, regs {r['sass']['registers']}")
        print(f"{key}: outputs and counters vs the first: "
              f"{', '.join(cells)} | " + " | ".join(rows))
    hw = [(f, d["line"]["handwritten_sass"]) for f, d in zip(files, loaded)
          if "handwritten_sass" in d["line"]]
    for f, h in hw[1:]:
        moved = sorted(k for k in set(hw[0][1]) | set(h)
                       if h.get(k) != hw[0][1].get(k))
        print(f"hand-written instances, {f} against {hw[0][0]}: "
              f"{len(h)} against {len(hw[0][1])}, SASS moved in "
              f"{len(moved)}: {moved[:8]}")
    print(json.dumps({"bit_for_bit": same_all}))
    return 0


def main():
    args = sys.argv[1:]
    if args[:1] == ["--compare"]:
        return compare(args[1:])
    import torch
    if not torch.cuda.is_available():
        print("traced_ab: no CUDA device is available", file=sys.stderr)
        return 2
    tree, out = ROOT, None
    if "--tree" in args:
        i = args.index("--tree")
        tree = Path(args[i + 1]).resolve()
        del args[i:i + 2]
    if "--out" in args:
        i = args.index("--out")
        out = args[i + 1]
        del args[i:i + 2]
    handwritten = "--handwritten" in args
    if out is None or set(args) - {"--handwritten"}:
        print(__doc__, file=sys.stderr)
        return 2
    importlib.import_module("chip_smoke")
    return run(tree, out, handwritten)


if __name__ == "__main__":
    sys.exit(main())
