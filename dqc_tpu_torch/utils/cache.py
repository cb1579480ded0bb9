"""On-disk cache of the expensive theta tensors (counterpart of
dqc_tpu/utils/cache.py).

Named arrays stored under prefixed keys in one .npz file, with a
human-readable signature of the system that wrote them: a file written for
another system (another signature) is ignored with a warning and its
entries are computed anew. `paramnames` limits the cache to the named
entries (a name with or without the prefix); None caches every one.
`fingerprint` is a second, port-only key beside the signature (a periodic
cell's basis and k-points, which the JAX package's signature of a cell
leaves out): a file written under another one is ignored the same way.
`cache_tree` stores a nested dict of tensors and plain values (a theta
part) as one entry group.

Tensors are stored as numpy on the host and come back as tensors on the
cache's device, with the bits they were stored with: a theta served from
the cache gives an SCF with the same bits as the one that wrote it. A
cached tensor has no autograd graph; qccalc serves it to run() only, never
to a derivative (which rebuilds theta from the params).
"""
from __future__ import annotations

import json
import os
import warnings
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


class Cache:
    def __init__(self, fname: Optional[str] = None, signature: str = "",
                 paramnames: Optional[List[str]] = None, prefix: str = "",
                 device="cpu", fingerprint: str = ""):
        self._fname = fname
        self._signature = signature
        self._fingerprint = fingerprint
        self._paramnames = paramnames  # None = cache everything registered
        self._prefix = prefix
        self._device = torch.device(device)
        self._store: Dict[str, np.ndarray] = {}
        self._loaded = False

    @classmethod
    def get_dummy(cls) -> "Cache":
        return cls(fname=None)

    def add_prefix(self, prefix: str) -> "Cache":
        """A view of the same store whose names live under `prefix`/."""
        c = Cache(self._fname, self._signature, self._paramnames,
                  self._prefix + prefix.rstrip("/") + "/", self._device,
                  self._fingerprint)
        c._store = self._store
        c._loaded = self._loaded
        return c

    def _enabled(self, name: str) -> bool:
        if self._fname is None:
            return False
        if self._paramnames is None:
            return True
        return (self._prefix + name) in self._paramnames or \
            name in self._paramnames

    def _load(self):
        if self._loaded or self._fname is None:
            return
        self._loaded = True
        if not os.path.exists(self._fname):
            return
        with np.load(self._fname, allow_pickle=False) as z:
            meta = json.loads(bytes(z["__meta__"]).decode()) \
                if "__meta__" in z.files else {}
            if ((self._signature
                 and meta.get("signature", "") != self._signature)
                    or meta.get("fingerprint", "") != self._fingerprint):
                warnings.warn(
                    f"Cache file {self._fname} was created for a different "
                    f"system (signature mismatch); ignoring its contents.")
                return
            for k in z.files:
                if k != "__meta__":
                    self._store[k] = z[k]

    def flush(self):
        """Write the store to the file (entries stored with flush=False)."""
        if self._fname is not None:
            self._flush()

    def _flush(self):
        payload = dict(self._store)
        payload["__meta__"] = np.frombuffer(
            json.dumps({"signature": self._signature,
                        "fingerprint": self._fingerprint}).encode(),
            dtype=np.uint8)
        # written beside the file and moved into place: a reader never sees
        # half a file
        tmp = f"{self._fname}.{os.getpid()}.tmp.npz"
        np.savez(tmp, **payload)
        os.replace(tmp, self._fname)

    def _tensor(self, a: np.ndarray):
        return torch.from_numpy(np.array(a)).to(self._device)

    @staticmethod
    def _array(t) -> np.ndarray:
        if isinstance(t, torch.Tensor):
            return t.detach().cpu().numpy()
        return np.asarray(t)

    def has(self, names: List[str]) -> bool:
        """Whether every entry of `names` is enabled and stored."""
        if not all(self._enabled(n) for n in names):
            return False
        self._load()
        return all(self._prefix + n in self._store for n in names)

    def cache(self, name: str, fcn: Callable):
        """The stored tensor `name`, or fcn() computed and stored."""
        return self.cache_multi([name], lambda: (fcn(),))[0]

    def cache_multi(self, names: List[str], fcn: Callable):
        """The stored tensors `names`, or the tuple fcn() computed and
        stored (all or none)."""
        keys = [self._prefix + n for n in names]
        if not all(self._enabled(n) for n in names):
            return tuple(fcn())
        if self.has(names):
            return tuple(self._tensor(self._store[k]) for k in keys)
        vals = tuple(fcn())
        for k, v in zip(keys, vals):
            self._store[k] = self._array(v)
        self._flush()
        return vals

    def has_tree(self, name: str) -> bool:
        """Whether the nested dict `name` is enabled and stored."""
        if not self._enabled(name):
            return False
        self._load()
        return self._prefix + name + "/__tree__" in self._store

    def cache_tree(self, name: str, fcn: Callable, flush: bool = True):
        """The nested dict `name` (tensors, and plain values: numbers,
        strings, None), loaded where the file holds it, else fcn() computed
        and stored (written to the file now, or with flush() later): each
        tensor under name/<keys>, the dict's shape and plain values in
        name/__tree__."""
        if not self._enabled(name):
            return fcn()
        key = self._prefix + name
        if self.has_tree(name):
            spec = json.loads(bytes(self._store[key + "/__tree__"]).decode())
            return self._unflatten(spec)
        tree = fcn()
        spec = self._flatten(tree, key)
        self._store[key + "/__tree__"] = np.frombuffer(
            json.dumps(spec).encode(), dtype=np.uint8)
        if flush:
            self._flush()
        return tree

    def _flatten(self, tree, key):
        spec = {}
        for k, v in tree.items():
            sub = f"{key}/{k}"
            if isinstance(v, dict):
                spec[k] = {"d": self._flatten(v, sub)}
            elif isinstance(v, torch.Tensor):
                self._store[sub] = self._array(v)
                spec[k] = {"t": sub}
            else:
                spec[k] = {"v": v}
        return spec

    def _unflatten(self, spec):
        out = {}
        for k, e in spec.items():
            if "d" in e:
                out[k] = self._unflatten(e["d"])
            elif "t" in e:
                out[k] = self._tensor(self._store[e["t"]])
            else:
                out[k] = e["v"]
        return out
