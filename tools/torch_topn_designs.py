"""Time design variants of the port's top-N select kernel on one NVIDIA GPU.

    python3 tools/torch_topn_designs.py [--n 60005376] [--k 1024] \
        [--variant NAME:CONST=VALUE,...] ...

Each variant is starrocks_tpu_torch/csrc/topn_select.cu with some of its
named `constexpr int` constants replaced (for example
`w4m2:kWarps=4,kMinCtas=2`), built with nvcc (sm_90a, `-Xptxas -v`) into
starrocks_tpu_torch/_build/designs/ and loaded with ctypes. Every variant
is held to the plain version bit for bit on N1-like keys (53-bit codes,
complemented) and timed with CUDA events at (N, k), beside its
registers and spills and, where the toolkit has cuobjdump, the sort
kernel's instruction mix. Then the candidates' reduction
(ops/sort.first_kk_desc) is timed piece by piece on N1-like and N2-like
(6-bit) keys. Prints one JSON line per measurement, the card's name and
power limit first. Needs the CUDA toolkit and a card; imports only the
port, torch and the standard library.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def cuda_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def build(name: str, consts: dict, out_dir: Path):
    """(library path, ptxas report) of the source with `consts` replaced."""
    from starrocks_tpu_torch.ops import kernels

    src = (kernels.CSRC / "topn_select.cu").read_text()
    for c, v in consts.items():
        src, n = re.subn(rf"constexpr int {c} = [^;]+;",
                         f"constexpr int {c} = {v};", src)
        if n != 1:
            raise SystemExit(f"{name}: no constant {c} in the source")
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"topn_{name}.cu"
    cu.write_text(src)
    lib = out_dir / f"libtopn_{name}.so"
    cmd = [kernels._nvcc(), "-Xptxas", "-v", *kernels.NVCC_FLAGS, "-o",
           str(lib), str(cu)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"{name}: nvcc failed\n{r.stdout}{r.stderr}")
    return lib, [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
                 if "registers" in ln or "spill" in ln
                 or "Function properties" in ln]


def sass_mix(lib: Path) -> dict:
    """Opcode counts of the first sort kernel, topn_sort_kernel<true,
    false> (empty without cuobjdump)."""
    from starrocks_tpu_torch.ops import kernels

    tool = Path(kernels._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    r = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                       text=True)
    mix: dict = {}
    inside = False
    for ln in r.stdout.splitlines():
        if "Function :" in ln:
            inside = "topn_sort_kernel" in ln and "ILb1ELb0E" in ln
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     ln)
        if inside and m:
            op = m.group(2).split(".")[0]
            mix[op] = mix.get(op, 0) + 1
    keep = ("LDL", "STL", "SHFL", "IMNMX", "VIMNMX", "ISETP", "SEL", "LDS", "STS",
            "LDGSTS", "STG", "BRA")
    out = {op: mix.get(op, 0) for op in keep}
    out["total"] = sum(mix.values())
    return out


def run_variant(lib_path: Path, neg, k: int):
    import torch

    from starrocks_tpu_torch.ops import kernels

    lib = ctypes.CDLL(str(lib_path))
    lib.sr_topn_select.argtypes = kernels._SIGNATURES["topn_select"][
        "sr_topn_select"]
    lib.sr_topn_select.restype = ctypes.c_int
    nb = neg.shape[0] // 1024
    vals = torch.empty(nb * k, dtype=torch.int64, device=neg.device)
    idx = torch.empty(nb * k, dtype=torch.int32, device=neg.device)
    wide = torch.empty(2 + 2 * nb, dtype=torch.int32, device=neg.device)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = lib.sr_topn_select(neg.data_ptr(), neg.shape[0], k,
                                vals.data_ptr(), idx.data_ptr(),
                                wide.data_ptr(), stream)
        if rc:
            raise RuntimeError(f"launch failed: {rc}")

    call()
    torch.cuda.synchronize()
    pv, pi = kernels.topn_select_plain(neg, k)
    same = torch.equal(vals, pv) and torch.equal(idx, pi)
    listed = wide[:2].tolist()  # blocks to the 64-bit pass, to pairs
    return same, cuda_ms(call), listed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=60_005_376)
    ap.add_argument("--k", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME:CONST=VALUE,... (default: the source as it is)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_topn_designs: no CUDA device", file=sys.stderr)
        return 2
    from starrocks_tpu_torch.ops import kernels
    from starrocks_tpu_torch.ops.sort import first_kk_desc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    n, k = args.n, args.k
    # N1's key: the price code (10,404,850 cents wide at SF 10) above 29
    # bits of (orderkey, linenumber)
    n1 = ~((torch.randint(0, 10_404_850, (n,), generator=g, device=dev) << 29)
           | torch.randint(0, 1 << 29, (n,), generator=g, device=dev))
    n2 = ~torch.randint(0, 50, (n,), generator=g, device=dev)
    out_dir = kernels.BUILD_DIR / "designs"
    for spec in args.variant or ["as_is:"]:
        name, _, body = spec.partition(":")
        consts = dict(kv.split("=") for kv in body.split(",") if kv)
        lib, ptxas = build(name, consts, out_dir)
        for label, x in (("n1", n1), ("n2_ties", n2)):
            same, ms, listed = run_variant(lib, x, k)
            print(json.dumps({"variant": name, "keys": label,
                              "consts": consts, "n": n, "k": k,
                              "equal_to_plain": same, "ms": ms,
                              "blocks_listed": listed, "ptxas": ptxas,
                              "sass": sass_mix(lib)}), flush=True)
    for label, x in (("n1", n1), ("n2_ties", n2)):
        cv, _ = kernels.topn_select(x, k)
        for route, y in (("pallas", cv), ("auto", x)):
            thr = torch.topk(y, k, sorted=False).values.min()
            pos = torch.nonzero(y >= thr).flatten()
            print(json.dumps({
                "reduction": f"{label}/{route}", "n": y.shape[0], "kk": k,
                "full_sort_ms": cuda_ms(lambda: torch.sort(
                    y, descending=True, stable=True), reps=5),
                "topk_ms": cuda_ms(lambda: torch.topk(y, k, sorted=False),
                                   reps=5),
                "compact_ms": cuda_ms(lambda: torch.nonzero(y >= thr),
                                      reps=5),
                "sort_compacted_ms": cuda_ms(lambda: torch.sort(
                    y[pos], descending=True, stable=True), reps=5),
                "compacted_rows": pos.shape[0],
                "threshold_ms": cuda_ms(lambda: first_kk_desc(y, k),
                                        reps=5)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
