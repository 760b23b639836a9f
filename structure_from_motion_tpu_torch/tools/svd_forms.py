"""Which operator form of the SVD runs on the card without a host read.

    python3 -m structure_from_motion_tpu_torch.tools.svd_forms

For each form of ``torch.linalg.svd`` (the default driver, each cuSOLVER
driver by name, the ``aten`` operators an exported program calls, and
``torch.svd``) at the frame path's shapes (the F-gate's 8 x 9 hypotheses,
a 2048 x 9 refit, 12 x 12 PnP samples, 4 x 4 triangulation rows, 3 x 3
factors), prints the host synchronisations torch reports in one call, by
call site, whether the call can be captured in a CUDA graph, and whether
its singular vectors have the bits of the default form. Card only.
"""

from __future__ import annotations

import json
import subprocess

import torch

SHAPES = {"8x9 hypotheses": (4096, 8, 9), "2048x9 refit": (16, 2048, 9),
          "12x12 PnP": (512, 12, 12), "4x4 triangulation": (4096, 4, 4),
          "3x3": (4096, 3, 3)}


def _forms() -> dict:
    aten = torch.ops.aten
    return {
        "linalg.svd": lambda A: torch.linalg.svd(A, full_matrices=A.shape[-2] < A.shape[-1]),
        **{f"linalg.svd driver={d}": (
            lambda A, d=d: torch.linalg.svd(A, full_matrices=A.shape[-2] < A.shape[-1],
                                            driver=d)) for d in ("gesvd", "gesvdj", "gesvda")},
        "aten.linalg_svd": lambda A: aten.linalg_svd.default(A, A.shape[-2] < A.shape[-1]),
        "aten._linalg_svd": lambda A: aten._linalg_svd.default(A, A.shape[-2] < A.shape[-1],
                                                               True),
        "torch.svd": lambda A: torch.svd(A, some=A.shape[-2] >= A.shape[-1]),
    }


def _captures(fn, A) -> str:
    """'yes' if ``fn(A)`` captures into a CUDA graph, else the error."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(A)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g):
            fn(A)
        g.replay()
        torch.cuda.synchronize()
        return "yes"
    except Exception as e:  # the capture's own refusal is the finding
        torch.cuda.synchronize()
        return f"no: {type(e).__name__}: {str(e).splitlines()[0][:120]}"


def run() -> dict:
    from structure_from_motion_tpu_torch.tools.slice_frames import host_syncs

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"card": card, "torch": torch.__version__}
    for label, shape in SHAPES.items():
        A = torch.randn(shape, generator=g, device="cuda")
        want = None
        for name, fn in _forms().items():
            try:
                fn(A)
                torch.cuda.synchronize()
                with host_syncs() as sites:
                    res = fn(A)
                    torch.cuda.synchronize()
            except Exception as e:  # a driver refusing a shape is recorded, not fatal
                out[f"{label} | {name}"] = f"refused: {type(e).__name__}: {str(e)[:120]}"
                continue
            vh = res[2] if name != "torch.svd" else res[2].transpose(-1, -2)
            want = vh if want is None else want
            out[f"{label} | {name}"] = dict(
                syncs=dict(sites),
                captures=_captures(fn, A) if not sites else "not tried: it synchronises",
                same_bits_as_default=bool(torch.equal(vh, want)))
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    run()
