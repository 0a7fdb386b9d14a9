"""Host-resident LoRA adapter store with bounded device slots.

The port's own copy of `dynamo_tpu/lora/registry.py`. Two tiers:

- **Host store**: every registered adapter's rank-padded numpy stacks
  (`register()` from an `adapter.npz` / HF-PEFT safetensors directory, or
  from in-memory tensors). Registration validates shapes and rank against
  the base model config, so a wrong-base adapter fails at load time, not
  with a shape error mid-request.
- **Device slots**: `EngineConfig.lora_slots` slots (1..S) of the engine's
  stacks (`apply.Stacks`: [L, S+1, in, R] and [L, S+1, R, out] in the
  model dtype; slot 0 is the reserved all-zero base slot). `acquire_slot()`
  lazily loads an adapter into a free slot, or LRU-evicts a resident
  adapter no live sequence is using, with one in-place copy per matrix
  under the engine's exec lock, so swaps serialize against decode steps
  (and a captured decode step reads the new weights: the stacks keep
  their storage).

The serving layer exposes this through `GET/POST /v1/adapters`.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import os
import re
import threading
from typing import Dict, List, Optional

import numpy as np

from dynamo_tpu_torch.lora import apply as lora_apply

log = logging.getLogger("dynamo_tpu_torch.lora")

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


class NoFreeAdapterSlot(RuntimeError):
    """Every device slot is held by an adapter with live sequences."""


@dataclasses.dataclass
class HostAdapter:
    name: str
    rank: int
    alpha: float
    path: Optional[str]
    # target -> ('a': [L, in, Rmax], 'b': [L, Rmax, out]); the alpha/rank
    # scale is already folded into B, rank already padded to the engine max
    tensors: Dict[str, np.ndarray]


def save_adapter_npz(path: str, tensors: Dict[str, np.ndarray],
                     rank: int, alpha: Optional[float] = None) -> None:
    """Write an adapter directory in the repo-native layout: adapter.npz
    with keys '<t>a'/'<t>b' ([L, in, r] / [L, r, out]) + adapter_config.json
    carrying {r, lora_alpha}."""
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "adapter.npz"), **tensors)
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"r": rank, "lora_alpha": alpha if alpha is not None
                   else rank}, f)


def _load_adapter_dir(path: str):
    """-> (tensors {'<t>a'/'<t>b': [L, ...]}, rank, alpha). Supports the
    repo-native adapter.npz layout and HF-PEFT safetensors naming
    (`...layers.{i}.self_attn.{t}_proj.lora_{A,B}.weight`, stored
    [r, in] / [out, r] per layer)."""
    cfg_path = os.path.join(path, "adapter_config.json")
    rank, alpha = None, None
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            c = json.load(f)
        rank = c.get("r")
        alpha = c.get("lora_alpha")
    npz = os.path.join(path, "adapter.npz")
    if os.path.exists(npz):
        with np.load(npz) as z:
            tensors = {k: np.asarray(z[k]) for k in z.files}
        return tensors, rank, alpha
    st = os.path.join(path, "adapter_model.safetensors")
    if os.path.exists(st):
        from safetensors import safe_open

        per_layer: Dict[str, Dict[int, np.ndarray]] = {}
        layer_re = re.compile(
            r"layers\.(\d+)\.self_attn\.([qkvo])_proj\.lora_([AB])\.weight$")
        with safe_open(st, framework="numpy") as f:
            for key in f.keys():
                m = layer_re.search(key)
                if not m:
                    continue
                li, t, ab = int(m.group(1)), m.group(2), m.group(3)
                w = np.asarray(f.get_tensor(key), np.float32)
                # peft stores A [r, in] and B [out, r]; engine layout is
                # A [in, r], B [r, out]
                per_layer.setdefault(t + ab.lower(), {})[li] = w.T
        tensors = {}
        for k, by_layer in per_layer.items():
            layers = [by_layer[i] for i in sorted(by_layer)]
            tensors[k] = np.stack(layers, axis=0)
        if tensors:
            return tensors, rank, alpha
    raise ValueError(
        f"no adapter found under {path!r} (need adapter.npz or "
        f"adapter_model.safetensors)")


class LoRARegistry:
    """Per-engine adapter registry (engine.lora). Thread-safe: HTTP
    management threads and the scheduler's admission path both call it.
    `stacks` are the device stacks every forward of the engine reads."""

    def __init__(self, engine):
        self.engine = engine
        cfg = engine.cfg
        mcfg = engine.model_cfg
        if mcfg.is_mla:
            raise ValueError(
                "multi-LoRA serving does not support MLA models yet (the "
                "absorbed-latent projections need a different placement)")
        self.max_rank = max(1, int(cfg.lora_rank))
        self.num_slots = int(cfg.lora_slots)
        self._host: Dict[str, HostAdapter] = {}
        # resident name -> device slot, in LRU order (oldest first)
        self._resident: "collections.OrderedDict[str, int]" = (
            collections.OrderedDict())
        self._free: List[int] = list(range(self.num_slots, 0, -1))
        self._lock = threading.RLock()
        self.swaps_total = 0  # device (re)loads of an adapter into a slot
        self.evictions_total = 0
        self.requests_total: Dict[str, int] = {}
        self._dims = lora_apply.target_dims(mcfg)
        self.stacks = lora_apply.Stacks.zeros(
            mcfg, self.num_slots + 1, self.max_rank, engine.device,
            engine.dtype)

    # ------------------------------------------------------------- host tier
    def register(self, name: str, path: Optional[str] = None,
                 tensors: Optional[Dict[str, np.ndarray]] = None,
                 rank: Optional[int] = None,
                 alpha: Optional[float] = None) -> HostAdapter:
        """Add (or replace) a host-store adapter from a directory or from
        in-memory tensors. Raises ValueError on bad names/shapes/ranks."""
        if not _NAME_RE.match(name or ""):
            raise ValueError(
                f"invalid adapter name {name!r} (alphanumeric plus ._- , "
                f"max 64 chars; ':' is the base/adapter separator)")
        if tensors is None:
            if not path:
                raise ValueError("need a path or tensors to register")
            tensors, file_rank, file_alpha = _load_adapter_dir(path)
            rank = rank if rank is not None else file_rank
            alpha = alpha if alpha is not None else file_alpha
        tensors = {k: np.asarray(v, np.float32) for k, v in tensors.items()}
        if rank is None:
            rank = next(iter(tensors.values())).shape[-1] \
                if tensors else self.max_rank
            for t in self._dims:
                if t + "a" in tensors:
                    rank = tensors[t + "a"].shape[-1]
                    break
        rank = int(rank)
        alpha = float(alpha) if alpha is not None else float(rank)
        scale = alpha / rank
        l = self.engine.model_cfg.num_layers
        padded: Dict[str, np.ndarray] = {}
        for t, (d_in, d_out) in self._dims.items():
            a, b = tensors.get(t + "a"), tensors.get(t + "b")
            if a is None and b is None:
                # untargeted projection: stays the zero delta
                continue
            if a is None or b is None:
                raise ValueError(f"adapter {name!r}: target {t!r} needs "
                                 f"both A and B matrices")
            if a.shape != (l, d_in, rank) or b.shape != (l, rank, d_out):
                raise ValueError(
                    f"adapter {name!r}: target {t!r} shapes "
                    f"A{a.shape}/B{b.shape} do not match the base model "
                    f"(want A{(l, d_in, rank)} / B{(l, rank, d_out)})")
            a, b = lora_apply.pad_rank(a, b * scale, self.max_rank)
            padded[t + "a"], padded[t + "b"] = a, b
        if not padded:
            raise ValueError(
                f"adapter {name!r} targets none of {list(self._dims)}")
        ad = HostAdapter(name, rank, alpha, path, padded)
        with self._lock:
            slot = self._resident.get(name)
            self._host[name] = ad
        if slot is not None:
            # re-registration replaces the weights: refresh the device copy
            self._write_slot(ad, slot)
        log.info("registered adapter %s (rank %d, alpha %g, targets %s)",
                 name, rank, alpha, sorted({k[0] for k in padded}))
        return ad

    def unregister(self, name: str) -> None:
        self.unload(name)
        with self._lock:
            self._host.pop(name, None)

    def known(self, name: str) -> bool:
        with self._lock:
            return name in self._host

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._host)

    def resident(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._resident)

    def slot_of(self, name: str) -> Optional[int]:
        with self._lock:
            return self._resident.get(name)

    # ----------------------------------------------------------- device tier
    def _in_use_slots(self) -> set:
        """Slots pinned by live sequences (active batch + the in-flight
        chunked prefill). Pending requests are NOT pins: their admission
        re-acquires (and reloads if needed)."""
        eng = self.engine
        used = {s.adapter_slot for s in eng.seqs.values()}
        inf = eng._inflight
        if inf is not None:
            used.add(inf.aslot)
        used.discard(0)
        return used

    def _write_slot(self, ad: HostAdapter, slot: int) -> None:
        """Copy one adapter's stacks into device slot `slot` (serialized
        against decode steps by the engine exec lock)."""
        with self.engine._exec_lock:
            self.stacks.write_slot(slot, ad.tensors)
        self.swaps_total += 1

    def acquire_slot(self, name: str) -> int:
        """Resolve an adapter name to its device slot, lazily loading (and
        LRU-evicting an idle resident if every slot is taken). Raises
        KeyError for unregistered names, NoFreeAdapterSlot when all slots
        are pinned by live sequences."""
        with self._lock:
            slot = self._resident.get(name)
            if slot is not None:
                self._resident.move_to_end(name)
                return slot
            ad = self._host.get(name)
            if ad is None:
                raise KeyError(f"unknown adapter {name!r}")
            if self._free:
                slot = self._free.pop()
            else:
                pinned = self._in_use_slots()
                victim = next((n for n, s in self._resident.items()
                               if s not in pinned), None)
                if victim is None:
                    raise NoFreeAdapterSlot(
                        f"all {self.num_slots} adapter slots are serving "
                        f"live sequences; retry shortly")
                slot = self._resident.pop(victim)
                self.evictions_total += 1
                log.info("evicting adapter %s from slot %d for %s",
                         victim, slot, name)
            self._resident[name] = slot
        self._write_slot(ad, slot)
        log.info("loaded adapter %s into device slot %d", name, slot)
        return slot

    def unload(self, name: str) -> bool:
        """Drop an adapter's device slot (host copy stays registered).
        False when it wasn't resident; raises NoFreeAdapterSlot while live
        sequences still use it."""
        with self._lock:
            slot = self._resident.get(name)
            if slot is None:
                return False
            if slot in self._in_use_slots():
                raise NoFreeAdapterSlot(
                    f"adapter {name!r} is serving live sequences")
            del self._resident[name]
            self._free.append(slot)
        return True

    def note_request(self, name: str) -> None:
        with self._lock:
            self.requests_total[name] = self.requests_total.get(name, 0) + 1

    def stats(self) -> Dict:
        with self._lock:
            return {
                "slots_total": self.num_slots,
                "slots_free": len(self._free),
                "registered": sorted(self._host),
                "resident": dict(self._resident),
                "swaps_total": self.swaps_total,
                "evictions_total": self.evictions_total,
                "requests_total": dict(self.requests_total),
                "stack_bytes": self.stacks.nbytes,
            }

    def describe(self) -> List[Dict]:
        """The GET /v1/adapters payload."""
        with self._lock:
            return [{
                "name": n,
                "rank": ad.rank,
                "alpha": ad.alpha,
                "path": ad.path,
                "resident": n in self._resident,
                "slot": self._resident.get(n),
                "requests": self.requests_total.get(n, 0),
            } for n, ad in sorted(self._host.items())]


def parse_adapter_list(spec: str) -> List:
    """'name=/path,other=/path2' (the --lora-adapters form) ->
    [(name, path)]."""
    out = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, path = part.partition("=")
        if not sep or not name or not path:
            raise ValueError(
                f"bad --lora-adapters entry {part!r} (want name=/path)")
        out.append((name.strip(), path.strip()))
    return out
