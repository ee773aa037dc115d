"""One capability probe: its inputs, its plain PyTorch version and its
kernel in csrc/probes.cu.

A `Probe` is called as `probe(device, *params)`: for a CPU device it runs
the plain version; for a CUDA device it launches the kernel (`llr_probe_
<name>`) or raises. `probe.launch(ins, outs)` is the bare launch into
preallocated outputs, and the only place that raises `probe.launches`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import torch

from ..ops import cuda_build


@functools.lru_cache(maxsize=None)
def _optin_bytes(index: int) -> int:
    v = ctypes.c_int()
    rc = cuda_build.fn("probes", "llr_probe_smem_limit")(ctypes.byref(v), index)
    if rc != 0:
        raise RuntimeError(f"cudaDeviceGetAttribute failed: CUDA error {rc}")
    return v.value


def smem_limit(device) -> int | None:
    """Bytes of shared memory one block may opt in to on a CUDA device
    (cudaDevAttrMaxSharedMemoryPerBlockOptin); None for the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return _optin_bytes(dev.index if dev.index is not None else torch.cuda.current_device())


def bag_sum_call(weight: torch.Tensor, index: torch.Tensor):
    """One `torch.nn.functional.embedding_bag(mode="sum")` call over the rows
    of `weight` at the int64 positions `index`, one bag, its offsets made
    beforehand: a function of no arguments returning the (1, cols) sum. The
    bag starts from 0 and adds its rows in index order, in float32 for a
    float32 weight: the probes' in-order sums, for a table's rows (weight
    the table) or its elements (weight its flat (rows*cols, 1) view)."""
    offsets = torch.zeros(1, dtype=torch.int64, device=weight.device)
    return lambda: torch.nn.functional.embedding_bag(index, weight, offsets, mode="sum")


def _same(res: torch.Tensor, want: torch.Tensor) -> bool:
    """`res` bit for bit `want`, broadcast to its shape (a library call may
    leave the broadcast to a view)."""
    return bool(torch.equal(res.expand(want.shape).contiguous().view(torch.int32),
                            want.view(torch.int32)))


class Probe:
    """A capability probe and its kernel.

    name      the kernel's entry is `llr_probe_<name>`;
    label     the JAX probe's name in its tool (function name, or the
              string `pallas_probe.py` prints);
    replaces  the JAX probe's file:line;
    inputs    (device, *params) -> the probe's input tensors, built as its
              tool builds them;
    compute   the plain PyTorch version on those inputs;
    out_shape the float32 output's shape;
    work      inputs -> (bytes, flops) the function needs on this data (for
              the bound: each needed input byte read once, the output
              written once);
    library   inputs -> a function of no arguments that makes one PyTorch
              call computing the same function and returns its result, or
              None where there is none (timed as a yardstick only).
    """

    def __init__(self, name: str, label: str, replaces: str, inputs: Callable,
                 compute: Callable, out_shape: tuple, work: Callable,
                 library: Callable | None = None):
        self.name, self.label, self.replaces = name, label, replaces
        self.inputs, self.compute, self.out_shape = inputs, compute, out_shape
        self.work, self.library = work, library
        self.launches = 0
        cuda_build.ARGTYPES[f"llr_probe_{name}"] = cuda_build.PROBE_ARGS

    def plain(self, device, *params) -> torch.Tensor:
        """The plain version on the probe's inputs, on `device`."""
        return self.compute(*self.inputs(torch.device(device), *params))

    def __call__(self, device, *params) -> torch.Tensor:
        return self.run(self.inputs(torch.device(device), *params))

    def run(self, ins) -> torch.Tensor:
        """The probe on inputs `ins`: the plain version where they lie on
        the CPU, else the kernel into new outputs."""
        dev = ins[0].device
        if dev.type == "cpu":
            return self.compute(*ins)
        outs = self.outputs(dev)
        self.launch(ins, outs)
        return outs[0]

    def library_agrees(self, ins) -> bool:
        """Whether the library call returns the plain version's output bit
        for bit on `ins`."""
        return _same(self.library(ins)(), self.compute(*ins))

    def outputs(self, device) -> list:
        """The output, uninitialised, in a list."""
        return [torch.empty(self.out_shape, dtype=torch.float32, device=device)]

    def launch(self, ins, outs):
        """The kernel alone: reads `ins`, writes `outs` (from `outputs`), all
        on the card; the launch `launches` counts. Raises RuntimeError where
        the entry returns an error."""
        dev = outs[0].device
        if dev.type != "cuda":
            raise ValueError(f"the {self.name} probe kernel takes CUDA tensors, not {dev}")
        if [tuple(o.shape) for o in outs] != [self.out_shape] or outs[0].dtype != torch.float32:
            raise ValueError(f"{self.name}: the output must be float32 of shape {self.out_shape}")
        for t in (*ins, *outs):
            if t.device != dev or not t.is_contiguous():
                raise ValueError(f"{self.name}: every tensor must be contiguous on {dev}")
        a = ins[0].data_ptr()
        b = ins[1].data_ptr() if len(ins) > 1 else None
        with torch.cuda.device(dev):
            rc = cuda_build.fn("probes", f"llr_probe_{self.name}")(
                a, b, None, outs[0].data_ptr(), ins[0].shape[0], cuda_build.stream())
            self.check(rc)
        self.launches += 1

    def check(self, rc: int):
        """Raise RuntimeError for an entry's nonzero return code `rc`: the
        kernel was not launched (a refused launch, or inputs the entry
        refuses, such as a misaligned table)."""
        cuda_build.check(rc, f"{self.name} probe")


cuda_build.ARGTYPES["llr_probe_empty"] = cuda_build.PROBE_ARGS


def launch_empty():
    """An empty kernel (csrc/probes.cu::probe_empty): the launch floor the
    probes sit on. Counted nowhere."""
    rc = cuda_build.fn("probes", "llr_probe_empty")(None, None, None, None, 0,
                                                    cuda_build.stream())
    cuda_build.check(rc, "empty probe")


cuda_build.ARGTYPES["llr_probe_empty_cluster"] = cuda_build.PROBE_ARGS


def launch_empty_cluster(barrier: bool):
    """An empty kernel with onehot_matmul_gather's grid and clusters
    (csrc/probes.cu::probe_empty_cluster), passing one cluster barrier if
    `barrier`: the floor that kernel sits on. Counted nowhere."""
    rc = cuda_build.fn("probes", "llr_probe_empty_cluster")(None, None, None, None,
                                                            int(barrier), cuda_build.stream())
    cuda_build.check(rc, "empty cluster probe")


def onehot_geometry() -> dict:
    """The launch geometry of onehot_matmul_gather's kernel: its grid and
    block, its cluster size and static shared memory as the loaded kernel
    reports them (cudaFuncGetAttributes), and how many of its clusters the
    card holds at once (cudaOccupancyMaxActiveClusters)."""
    entry = "llr_probe_geometry_onehot_matmul_gather"
    cuda_build.ARGTYPES[entry] = [ctypes.POINTER(ctypes.c_int)]
    v = (ctypes.c_int * 5)()
    rc = cuda_build.fn("probes", entry)(v)
    if rc != 0:
        raise RuntimeError(f"onehot_matmul_gather's geometry: CUDA error {rc}")
    return dict(zip(("grid", "block", "cluster", "smem_bytes", "max_active_clusters"), v))


def static_smem(name: str) -> int:
    """Bytes of static shared memory the kernel of probe `name` declares, as
    the loaded library reports it (cudaFuncGetAttributes); exported by
    csrc/probes.cu for the probes that read their table straight from L2."""
    entry = f"llr_probe_static_smem_{name}"
    cuda_build.ARGTYPES[entry] = [ctypes.POINTER(ctypes.c_int)]
    v = ctypes.c_int()
    rc = cuda_build.fn("probes", entry)(ctypes.byref(v))
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed for {name}: CUDA error {rc}")
    return v.value
