"""Where the kernels' build time goes, and whether the closed instances kept
their code.

    python -m nextsimdg_tpu_torch.benchmarks.build_report --times
    python -m nextsimdg_tpu_torch.benchmarks.build_report --sass PARENT_LIB [LIB]

``--times`` compiles every source of ``csrc/`` as ``coupled_cuda.build()``
does (all at once, the same flags) into a scratch directory beside the
library and prints when each finished: the build's wall time is the
longest. ``--sass`` compares, by ``cuobjdump -sass``, the opcode sequences
(operands ignored) of the kernels in LIB (default: this tree's library,
built if missing) with those of another checkout's library PARENT_LIB, for
the instances that this tree compiles with its added template arguments
false or 0 (the periodic form ``kWrap``, ``kTvb`` and ``kWalls`` of
transport_tiled, ``kHalo`` of dg1_rk_stage, the HO kernels' momentum form
``kForm``, and rdma_band's ``kMetric``, ``kForm`` and ``kWrap``), and
dg1_limit's single-domain instances: the closed instances, which should
be the parent's code. Both need the CUDA
toolkit (the card's machine); they launch nothing on the card.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

from ..dynamics.kernels import coupled_cuda as cc

#: The kernels whose closed instances gained false template arguments.
KERNELS = (
    "mevp_stress_kernel", "mevp_velocity_kernel", "mevp_tiled_kernel", "mevp_single_kernel",
    "transport_tiled_kernel", "dg1_rk_stage_kernel", "dg1_sample_cfl_kernel", "dg1_limit_kernel", "ho_single_kernel",
    "ho_tiled_kernel", "rdma_band_kernel", "rdma_stage_kernel", "fused_dynamics_kernel",
)
#: Trailing template arguments that are false or 0 (the closed forms).
_CLOSED_ARG = re.compile(r"L[bi]0E$")


def compile_times() -> dict:
    """Seconds from the start until each source's ``nvcc -c`` finished, all
    started together."""
    work = cc.BUILD_DIR / "times"
    work.mkdir(parents=True, exist_ok=True)
    cu, _ = cc._sources()
    start = time.perf_counter()
    jobs = {
        src.name: subprocess.Popen(
            [cc._nvcc(), *cc.NVCC_FLAGS, "-c", "-o", str(work / f"{src.stem}.o"), str(src)],
            cwd=cc.CSRC, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        for src in cu
    }
    done = {}
    while len(done) < len(jobs):
        for name, job in jobs.items():
            if name not in done and job.poll() is not None:
                if job.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {name}")
                done[name] = time.perf_counter() - start
        time.sleep(0.05)
    shutil.rmtree(work, ignore_errors=True)
    return done


def opcodes(sass: str) -> dict:
    """{mangled kernel name: [opcode, ...]} of ``cuobjdump -sass`` text."""
    out, name = {}, None
    for line in sass.splitlines():
        found = re.match(r"\s*Function : (\S+)", line)
        if found:
            name = found.group(1)
            out[name] = []
            continue
        found = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(@!?P\d+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name and found:
            out[name].append(found.group(2))
    return out


def closed_name(name: str, parent_names) -> str:
    """The parent's kernel of a closed instance: the template arguments of
    ``name`` without some of its trailing false or 0 ones (``Lb0E``,
    ``Li0E``), the fewest first, that name a kernel of the parent (the
    name itself where the parent has it); None for another instance."""
    key = name.split("EEv")[0]
    while True:
        if key in parent_names:
            return key
        stripped = _CLOSED_ARG.sub("", key)
        if stripped == key:
            return None
        key = stripped


def compare(parent: dict, new: dict) -> tuple:
    """(identical, differing lines) over the closed instances of ``new``."""
    by_key = {name.split("EEv")[0]: ops for name, ops in parent.items()}
    same, differ = 0, []
    for name, ops in sorted(new.items()):
        if not any(k in name for k in KERNELS):
            continue
        base = closed_name(name, by_key)
        if base is None:
            continue
        ref = by_key[base]
        if ops == ref:
            same += 1
        else:
            extra, missing = Counter(ops) - Counter(ref), Counter(ref) - Counter(ops)
            differ.append(f"{name[:90]}: parent {len(ref)}, this tree {len(ops)}; +{dict(extra)} -{dict(missing)}")
    return same, differ


def _sass(lib) -> dict:
    text = subprocess.run([str(Path(cc._nvcc()).with_name("cuobjdump")), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    return opcodes(text)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--times" in argv:
        times = compile_times()
        print("each source, all started together: " + ", ".join(
            f"{name} {t:.1f} s" for name, t in sorted(times.items(), key=lambda x: x[1])), flush=True)
    if "--sass" in argv:
        rest = argv[argv.index("--sass") + 1:]
        parent = rest[0]
        lib = rest[1] if len(rest) > 1 and not rest[1].startswith("--") else cc.build()
        same, differ = compare(_sass(parent), _sass(lib))
        for line in differ:
            print("differs:", line)
        print(f"closed instances: {same} with the parent's opcode sequence, {len(differ)} differ", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
