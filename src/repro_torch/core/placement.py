"""Placement backends: how GPU counts become concrete device sets.

The Schedule IR says *how many* GPUs a job gets; a placement backend
decides *which* ones, and thereby which co-locations are legal:

- :class:`FlatPool` — the legacy behavior: one undifferentiated pool,
  any free devices satisfy any request (node boundaries ignored).
- :class:`NodeAware` — honors what ``solve_joint_nodes`` plans: a
  single-node config (g <= gpus_per_node) must fit inside ONE node's
  free capacity; larger configs must be whole-node multiples and take
  entirely free nodes.  Two 5-GPU jobs can therefore never share one
  8-GPU node.
- :class:`ClassPool` — heterogeneous clusters: one free pool PER device
  class over contiguous global-id ranges.  A class-pinned request
  (``device_class=...``) only draws from that class; an unpinned
  (class-blind) request takes the first class with room, in declaration
  order.  A single allocation never straddles classes.

Select via ``ClusterSpec(placement="flat"|"node")``; clusters with more
than one :class:`~repro_torch.core.job.DeviceClass` always get a ClassPool.

FlatPool and ClassPool are ELASTIC (``supports_elasticity``): the chaos
layer (:mod:`.chaos`) shrinks them by removing concrete free devices and
grows them with :meth:`~PlacementBackend.add_devices`, which always
mints FRESH ids — an id that ever left the pool is never reissued, so
Gantt history, per-class accounting and the conservation check stay
unambiguous across arbitrary shrink/grow sequences (``class_of`` keeps
answering for removed devices).  NodeAware does not support elasticity:
node-aware plans encode node indices that renumber under churn.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from .job import DEFAULT_CLASS
from .schedule import Placement


class PlacementError(RuntimeError):
    """A planned entry can never be hosted by this backend."""


class PlacementBackend:
    kind = "base"
    supports_elasticity = False

    def __init__(self, total_gpus: int):
        self.total_gpus = total_gpus

    @property
    def free_gpus(self) -> int:
        raise NotImplementedError

    def feasible(self, n_gpus: int,
                 device_class: Optional[str] = None) -> bool:
        """Could a request of this size EVER be placed (empty cluster)?"""
        raise NotImplementedError

    def allocate(self, n_gpus: int,
                 preferred_nodes: Optional[Sequence[int]] = None,
                 device_class: Optional[str] = None
                 ) -> Optional[Placement]:
        """Return a Placement or None if it does not fit right now."""
        raise NotImplementedError

    def release(self, placement: Placement) -> None:
        raise NotImplementedError

    def class_of(self, device: int) -> str:
        """Which device class a global device id belongs to."""
        return DEFAULT_CLASS

    # ------------------------------------------------------- elasticity
    def capacity(self, device_class: Optional[str] = None) -> int:
        """Devices currently PRESENT (free + busy), optionally per class."""
        return self.total_gpus

    def free_devices(self, device_class: Optional[str] = None
                     ) -> Tuple[int, ...]:
        """The concrete free device ids, optionally per class."""
        raise NotImplementedError

    def remove_devices(self, devices: Sequence[int]) -> None:
        """Shrink: take concrete FREE devices out of the pool (callers
        kill/release any launch on them first).  ``class_of`` keeps
        answering for removed ids."""
        raise PlacementError(
            f"placement backend {self.kind!r} does not support "
            f"elasticity (shrink/grow)")

    def add_devices(self, n: int,
                    device_class: Optional[str] = None
                    ) -> Tuple[int, ...]:
        """Grow: add ``n`` devices with FRESH ids (never reused) and
        return them."""
        raise PlacementError(
            f"placement backend {self.kind!r} does not support "
            f"elasticity (shrink/grow)")


class FlatPool(PlacementBackend):
    """One big pool of interchangeable GPUs (today's executor model).

    Elastic: ``total_gpus`` tracks the present pool, so ``feasible``
    tightens under shrink and relaxes under grow.  Device classes are
    ignored — the whole pool is the single "default" class.
    """

    kind = "flat"
    supports_elasticity = True

    def __init__(self, total_gpus: int):
        super().__init__(total_gpus)
        self._free = list(range(total_gpus))   # kept sorted
        self._next_id = total_gpus             # fresh ids for add_devices

    @property
    def free_gpus(self) -> int:
        return len(self._free)

    def feasible(self, n_gpus, device_class=None):
        return 0 < n_gpus <= self.total_gpus

    def allocate(self, n_gpus, preferred_nodes=None, device_class=None):
        if n_gpus > len(self._free):
            return None
        devs = tuple(self._free[:n_gpus])
        del self._free[:n_gpus]
        return Placement(devs)

    def release(self, placement: Placement) -> None:
        self._free = sorted(set(self._free) | set(placement.devices))

    def free_devices(self, device_class=None):
        return tuple(self._free)

    def remove_devices(self, devices) -> None:
        victims = set(devices)
        missing = victims - set(self._free)
        if missing:
            raise PlacementError(
                f"cannot remove busy/unknown devices {sorted(missing)}")
        self._free = [d for d in self._free if d not in victims]
        self.total_gpus -= len(victims)

    def add_devices(self, n, device_class=None):
        fresh = tuple(range(self._next_id, self._next_id + n))
        self._next_id += n
        self._free = sorted(self._free + list(fresh))
        self.total_gpus += n
        return fresh


class NodeAware(PlacementBackend):
    """Per-node capacity: single-node configs best-fit into one node;
    whole-node-multiple configs take k fully free nodes."""

    kind = "node"

    def __init__(self, nodes: int, gpus_per_node: int):
        super().__init__(nodes * gpus_per_node)
        self.nodes = nodes
        self.gpus_per_node = gpus_per_node
        self._free: List[List[int]] = [
            list(range(nu * gpus_per_node, (nu + 1) * gpus_per_node))
            for nu in range(nodes)]

    @property
    def free_gpus(self) -> int:
        return sum(len(f) for f in self._free)

    def feasible(self, n_gpus, device_class=None):
        if n_gpus <= 0 or n_gpus > self.total_gpus:
            return False
        return (n_gpus <= self.gpus_per_node
                or n_gpus % self.gpus_per_node == 0)

    def _take(self, nu: int, n: int) -> Tuple[int, ...]:
        devs = tuple(self._free[nu][:n])
        del self._free[nu][:n]
        return devs

    def allocate(self, n_gpus, preferred_nodes=None, device_class=None):
        if not self.feasible(n_gpus):
            return None
        pref = list(preferred_nodes or [])
        if n_gpus <= self.gpus_per_node:
            # preferred node first, else best fit (smallest sufficient
            # free capacity) to limit fragmentation; ties -> lowest id
            for nu in pref:
                if 0 <= nu < self.nodes and len(self._free[nu]) >= n_gpus:
                    return Placement(self._take(nu, n_gpus))
            cands = [(len(self._free[nu]), nu) for nu in range(self.nodes)
                     if len(self._free[nu]) >= n_gpus]
            if not cands:
                return None
            _, nu = min(cands)
            return Placement(self._take(nu, n_gpus))
        k = n_gpus // self.gpus_per_node
        empty = [nu for nu in range(self.nodes)
                 if len(self._free[nu]) == self.gpus_per_node]
        if len(empty) < k:
            return None
        chosen = [nu for nu in pref if nu in empty][:k]
        for nu in empty:
            if len(chosen) >= k:
                break
            if nu not in chosen:
                chosen.append(nu)
        devs: Tuple[int, ...] = ()
        for nu in sorted(chosen):
            devs += self._take(nu, self.gpus_per_node)
        return Placement(devs)

    def release(self, placement: Placement) -> None:
        for d in placement.devices:
            nu = d // self.gpus_per_node
            self._free[nu].append(d)
        for nu in range(self.nodes):
            self._free[nu].sort()


class ClassPool(PlacementBackend):
    """Heterogeneous clusters: one flat free pool per device class.

    Initial global device ids are contiguous per class in declaration
    order (matching :meth:`ClusterSpec.device_ranges`); elastic grows
    append fresh ids past the initial ranges.  The id -> class map is
    persistent — it keeps answering for removed devices, because Gantt
    entries and the conservation check reference them after the fact.
    """

    kind = "class"
    supports_elasticity = True

    def __init__(self, classes: Sequence):
        # classes: Sequence[repro_torch.core.job.DeviceClass]
        classes = tuple(classes)
        super().__init__(sum(dc.total_gpus for dc in classes))
        if not classes:
            raise ValueError("ClassPool needs at least one device class")
        self.classes = classes
        self._free = {}
        self._cap = {}                 # class -> devices present (free+busy)
        self._dev_class = {}           # id -> class, persistent
        off = 0
        for dc in classes:
            self._free[dc.name] = list(range(off, off + dc.total_gpus))
            self._cap[dc.name] = dc.total_gpus
            for d in range(off, off + dc.total_gpus):
                self._dev_class[d] = dc.name
            off += dc.total_gpus
        self._next_id = off

    @property
    def free_gpus(self) -> int:
        return sum(len(f) for f in self._free.values())

    def free_in(self, device_class: str) -> int:
        return len(self._free[device_class])

    def class_of(self, device: int) -> str:
        try:
            return self._dev_class[device]
        except KeyError:
            raise KeyError(f"device {device} outside cluster")

    def _capacity(self, device_class: str) -> int:
        return self._cap[device_class]

    def feasible(self, n_gpus, device_class=None):
        if n_gpus <= 0:
            return False
        if device_class is not None:
            if device_class not in self._cap:
                raise PlacementError(
                    f"unknown device class {device_class!r} "
                    f"(have {list(self._cap)})")
            return n_gpus <= self._capacity(device_class)
        return any(n_gpus <= self._capacity(n) for n in self._cap)

    def allocate(self, n_gpus, preferred_nodes=None, device_class=None):
        if device_class is not None and device_class not in self._free:
            raise PlacementError(
                f"unknown device class {device_class!r} "
                f"(have {list(self._free)})")
        names = ([device_class] if device_class is not None
                 else [dc.name for dc in self.classes])
        for name in names:
            free = self._free[name]
            if n_gpus <= len(free):
                devs = tuple(free[:n_gpus])
                del free[:n_gpus]
                return Placement(devs, device_class=name)
        return None

    def release(self, placement: Placement) -> None:
        for d in placement.devices:
            self._free[self.class_of(d)].append(d)
        for free in self._free.values():
            free.sort()

    def capacity(self, device_class: Optional[str] = None) -> int:
        if device_class is None:
            return self.total_gpus
        return self._cap[device_class]

    def free_devices(self, device_class=None):
        if device_class is None:
            return tuple(d for free in self._free.values() for d in free)
        return tuple(self._free[device_class])

    def remove_devices(self, devices) -> None:
        victims = list(devices)
        for d in victims:
            dc = self._dev_class.get(d)
            if dc is None or d not in self._free[dc]:
                raise PlacementError(
                    f"cannot remove busy/unknown device {d}")
        for d in victims:
            dc = self._dev_class[d]
            self._free[dc].remove(d)
            self._cap[dc] -= 1
        self.total_gpus -= len(victims)

    def add_devices(self, n, device_class=None):
        if device_class is None:
            if len(self.classes) != 1:
                raise PlacementError(
                    "add_devices on a multi-class pool needs an explicit "
                    "device_class")
            device_class = self.classes[0].name
        if device_class not in self._free:
            raise PlacementError(
                f"unknown device class {device_class!r} "
                f"(have {list(self._free)})")
        fresh = tuple(range(self._next_id, self._next_id + n))
        self._next_id += n
        for d in fresh:
            self._dev_class[d] = device_class
        self._free[device_class] = sorted(
            self._free[device_class] + list(fresh))
        self._cap[device_class] += n
        self.total_gpus += n
        return fresh


def make_backend(cluster, kind: Optional[str] = None) -> PlacementBackend:
    """Build the backend a ClusterSpec asks for (default: its
    ``placement`` field, falling back to flat).  Heterogeneous clusters
    always allocate from per-class pools."""
    if getattr(cluster, "hetero", False):
        if (kind or getattr(cluster, "placement", "flat")) == "node":
            raise ValueError("node-aware placement is not supported on "
                             "heterogeneous clusters yet; use per-class "
                             "pools (placement='flat')")
        return ClassPool(cluster.device_classes)
    kind = kind or getattr(cluster, "placement", "flat")
    if kind == "flat":
        return FlatPool(cluster.total_gpus)
    if kind == "node":
        return NodeAware(cluster.nodes, cluster.gpus_per_node)
    raise ValueError(f"unknown placement backend: {kind!r}")
