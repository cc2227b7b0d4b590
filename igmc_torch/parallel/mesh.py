"""Process groups: one process per device over torch.distributed.

Port of igmc_tpu/parallel/mesh.py. The JAX package drives every device of a
('data', 'model') mesh from one process and lets GSPMD place the shards and
insert the gradient psum. The port runs one process per device, PyTorch's
own idiom: a `Mesh` is one process's view of the group (its rank, the
group's size, its device and the backend), and the collectives of the
parallel paths (all_reduce, all_gather, all_to_all, barrier) go through it.

Backend rule (rank 0 prints the choice once on stderr):
  * nccl when each rank has a card of its own;
  * gloo on the CPU;
  * gloo when ranks share a card: NCCL refuses two ranks on one device.
    Gloo moves CUDA tensors through host memory; the Mesh stages them there
    itself. This is how a one-card machine runs a two-rank group (the
    counterpart of the JAX tests' 8-device virtual CPU backend); such
    ranks' times measure the port, not the interconnect.
Rank r uses cuda:(r % device_count) (r its rank on its host, LOCAL_RANK
under torchrun), or the CPU.

`batch_sharding` and `replicated_sharding` have no counterpart: there is
no global array. Each rank holds the parameters (identical by
construction: the same initial weights and the same all-reduced
gradients) and its own shard of every batch.

`spawn(fn, n, device)` starts n ranks with torch.multiprocessing and a
file:// rendezvous in a temporary directory (no TCP port), calls
fn(mesh, *args) on each and returns their results in rank order. A rank
that raises brings the others down, and its exception is raised again in
the caller; the group's timeout bounds any collective that a dead peer
leaves waiting. n = 1 runs in the calling process. The ranks spawn
starts talk over the loopback interface (GLOO_SOCKET_IFNAME and
NCCL_SOCKET_IFNAME default to lo). With WORLD_SIZE and RANK in the
environment (torchrun, on one host or many) spawn joins that group
instead (env:// rendezvous) and returns this rank's result alone: the
multi-host path.
"""

from __future__ import annotations

import datetime
import os
import pickle
import sys
import tempfile
import traceback
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

DEFAULT_TIMEOUT_S = 600


@dataclass
class Mesh:
    """This process's rank in a group of `size`, its device and the
    group's backend; `calls` counts the collectives it has issued, by
    name."""
    rank: int
    size: int
    device: torch.device
    backend: str
    calls: Counter = field(default_factory=Counter)

    @property
    def staged(self) -> bool:
        """Whether collectives copy CUDA tensors through host memory (gloo)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        t = t.detach().contiguous()
        return t.cpu() if self.staged else t

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self.staged else t

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of `t` over the ranks (a new tensor when
        staged, else `t` summed in place)."""
        self.calls["all_reduce"] += 1
        h = self._host(t)
        dist.all_reduce(h)
        return self._back(h)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` concatenated along dim 0, in rank order."""
        self.calls["all_gather"] += 1
        h = self._host(t)
        parts = [torch.empty_like(h) for _ in range(self.size)]
        dist.all_gather(parts, h)
        return self._back(torch.cat(parts))

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Equal splits of dim 0: chunk r of `t` goes to rank r, and chunk
        s of the result came from rank s."""
        self.calls["all_to_all"] += 1
        h = self._host(t)
        out = torch.empty_like(h)
        dist.all_to_all_single(out, h)
        return self._back(out)

    def barrier(self) -> None:
        self.calls["barrier"] += 1
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def backend_for(device, local_ranks: int) -> str:
    """nccl when `local_ranks` ranks each have a card of their own, else
    gloo (the CPU, or ranks sharing a card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= local_ranks:
        return "nccl"
    return "gloo"


def _rank_device(device, rank: int) -> torch.device:
    dev = resolve_device(device)          # TF32 off in every rank
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def init_group(rank: int, size: int, device="cuda", init_method: str = "env://",
               timeout: float = DEFAULT_TIMEOUT_S) -> str:
    """Initialise the default process group for this rank by the backend
    rule; returns the backend. LOCAL_WORLD_SIZE (torchrun) counts the
    ranks that share this host's cards, else all `size` do."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", size))
    backend = backend_for(device, local)
    dev = _rank_device(device, rank)
    if rank == 0:
        why = ("a card per rank" if backend == "nccl"
               else "CPU ranks" if dev.type == "cpu"
               else f"{local} ranks share {torch.cuda.device_count()} card(s); "
                    f"collectives staged through host memory")
        print(f"igmc_torch.parallel: {size} rank(s) over {backend} ({why})",
              file=sys.stderr, flush=True)
    dist.init_process_group(backend, init_method=init_method, world_size=size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout))
    return backend


def make_mesh(n_data: Optional[int] = None, device="cuda") -> Mesh:
    """The Mesh of this process inside an initialised default group.
    `n_data` (if given) must equal the group's size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(spawn, or init_group under torchrun)")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_data is not None and n_data != size:
        raise ValueError(f"n_data {n_data} != the group's size {size}")
    return Mesh(rank, size, _rank_device(device, rank), dist.get_backend())


def _result_path(out_dir: str, rank: int) -> str:
    return os.path.join(out_dir, f"rank{rank}.pkl")


def _run_rank(fn: Callable, rank: int, size: int, device, init_method: str,
              args: tuple, timeout: float):
    init_group(rank, size, device, init_method, timeout)
    try:
        return fn(make_mesh(size, device), *args)
    finally:
        dist.destroy_process_group()


def _entry(rank: int, fn: Callable, size: int, device, init_method: str,
           out_dir: str, args: tuple, timeout: float) -> None:
    """One spawned rank: run fn, write ("ok", result) or ("error",
    exception, traceback) for the parent, re-raise on error so that
    torch.multiprocessing brings the other ranks down."""
    torch.set_num_threads(max(1, torch.get_num_threads() // size))
    try:
        result = ("ok", _run_rank(fn, rank, size, device, init_method, args, timeout))
    except BaseException as e:
        result = ("error", e, traceback.format_exc())
        with open(_result_path(out_dir, rank), "wb") as f:
            pickle.dump(result, f)
        raise
    with open(_result_path(out_dir, rank), "wb") as f:
        pickle.dump(result, f)


def spawn(fn: Callable, n: int, device="cuda", args: tuple = (),
          timeout: float = DEFAULT_TIMEOUT_S) -> list:
    """fn(mesh, *args) on each of n ranks; their results in rank order (see
    the module docstring). `fn` must be importable by name (a module-level
    function) and its results picklable."""
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        size, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        if n not in (None, size):
            raise ValueError(f"asked for {n} ranks inside a group of {size}")
        return [_run_rank(fn, rank, size, device, "env://", args, timeout)]
    if n < 1:
        raise ValueError(f"spawn needs at least one rank, not {n}")
    import torch.multiprocessing as mp

    # the ranks of one host talk over its loopback interface (a host may
    # have no other, or a hostname that resolves to none)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")

    with tempfile.TemporaryDirectory(prefix="igmc_torch_group_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        if n == 1:
            return [_run_rank(fn, 0, 1, device, init_method, args, timeout)]
        try:
            mp.spawn(_entry, args=(fn, n, device, init_method, tmp, args, timeout),
                     nprocs=n, join=True)
        except Exception as e:
            for r in range(n):
                if os.path.isfile(_result_path(tmp, r)):
                    with open(_result_path(tmp, r), "rb") as f:
                        got = pickle.load(f)
                    if got[0] == "error":
                        raise got[1] from RuntimeError(f"rank {r}:\n{got[2]}")
            raise e
        out = []
        for r in range(n):
            with open(_result_path(tmp, r), "rb") as f:
                out.append(pickle.load(f)[1])
        return out
