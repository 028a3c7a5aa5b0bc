"""Async, crash-consistent training checkpoints (the port's counterpart of
``paddle_tpu.parallel.checkpoint``, single process).

Reference analog: save/load ops streamed per var (save_op.cc, load_op.cc;
io.py:487 save_persistables). The on-disk formats are the JAX package's,
so a checkpoint either package writes restores in the other: the pickle
bundle ``{"step", "vars"}`` (``ckpt-N.pkl``), the native framed bundle
(``ckpt-N.ptck``, ``native/src/ckptio.cc``), the SHA-256 manifest
``ckpt-N.manifest-R.json``, the ``latest`` marker, and the per-rank shard
files ``ckpt-N.index-R.json`` / ``ckpt-N.shards-R.pkl`` that a JAX mesh
run writes (restored here by ``_assemble_shards``).

Design:
- `save` snapshots every persistable var without blocking on the write.
  The port updates parameters IN PLACE (``torch._foreach_*``, in-place
  Adam and packed-table updates), so a writer that held the live tensors
  would write a later step's values. On the card, `save` enqueues each
  tensor's D2H copy into pinned host memory on the CURRENT (training)
  stream and records an event there: stream order puts every copy before
  the next step's in-place update. The writer thread waits on that event
  before it reads the bytes. On the CPU the snapshot is a host copy;
- files are written to a temp name, fsynced, and renamed; the per-file
  SHA-256 **manifest** is written last as the commit record, then the
  ``latest`` marker;
- `restore` verifies the manifest before loading anything; on any
  corruption or partial write it walks back newest→older to the most
  recent checkpoint that verifies (``checkpoint/fallback_steps`` counter,
  a warning naming the bad files);
- the background writer retries transient I/O errors with capped
  exponential backoff (``PDTPU_CKPT_RETRIES`` attempts,
  ``PDTPU_CKPT_RETRY_BACKOFF_MS`` base delay) before `wait()` surfaces
  the failure with the step and path (``checkpoint/write_retries``;
  ``checkpoint/write_ms`` and ``last_write_ms`` time a committed write);
- `restore` places values on the caller's place (``CUDAPlace(0)`` unless
  the caller passes another; with no GPU and no place it raises). A value
  already in the scope with the same shape, dtype and device takes the
  new bytes in place; any other is replaced (the executor's plans hold
  names, not tensors).

The random stream. The port's generator (a ``torch.Generator`` on the
scope under ``@RNG_STATE@``) is saved as ``@rng@`` (its ``get_state()``)
with ``@rng_impl@`` naming its kind, ``torch:cuda`` or ``torch:cpu``.
`restore` sets it into a generator on the restore device when the kinds
match, so dropout resumes the same stream; a checkpoint whose ``@rng@``
is of another kind (a JAX key, or the other device's generator) loads
every variable, leaves the scope's generator as it is, and warns once,
naming both kinds. The JAX package cannot read a torch generator state:
a port checkpoint that carries one does not restore there.

Not ported here: writing sharded tensors (ROADMAP A9), and the PS tables'
checkpoints — ``ps_tables=`` in `save` and `restore`, `save_delta` and
`load_ps_table` — which raise naming ROADMAP A8.

Chaos probes (``faults``): ``ckpt.bundle_write``, ``ckpt.rename`` and
``ckpt.marker`` sit at every commit edge.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import threading
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.dtypes import from_numpy, to_device
from ..core.executor import _RNG_STATE, CUDAPlace
from ..core.program import Program, default_main_program
from ..core.scope import Scope, _scope
from ..faults import fault_point
from ..observability.registry import get_registry

_OBS = get_registry()
# restore skipped a bad checkpoint and fell back to an older one
_FALLBACK = _OBS.counter("checkpoint/fallback_steps")
# background writer retried a transient I/O failure
_RETRIES = _OBS.counter("checkpoint/write_retries")
# a background write, from the snapshot's copies to the marker's rename
_WRITE_MS = _OBS.histogram("checkpoint/write_ms")

_PS_TODO = ("PS table checkpoints (ps_tables=, save_delta, load_ps_table) "
            "need ShardedTable.dump_shard / load_full, which are not "
            "ported yet (ROADMAP A8)")


def _snapshot(program: Program, scope: Scope):
    """(vals, event): a host copy of every persistable in the scope, and
    the CUDA event the copies complete at (None when nothing came from
    the card). Device tensors go to pinned host memory through
    ``non_blocking`` copies on the current stream; host tensors and numpy
    arrays are copied now."""
    out: Dict[str, object] = {}
    on_card = False
    for v in program.list_vars():
        if not v.persistable:
            continue
        val = scope.find_var(v.name)
        if val is None:
            continue
        if isinstance(val, torch.Tensor):
            t = val.detach()
            u16 = t.dtype == torch.uint16
            src = t.view(torch.int16) if u16 else t
            if src.device.type == "cuda":
                host = torch.empty(src.shape, dtype=src.dtype,
                                   pin_memory=True)
                host.copy_(src, non_blocking=True)
                on_card = True
            else:
                host = src.clone()
            out[v.name] = host.view(torch.uint16) if u16 else host
        elif isinstance(val, np.ndarray) or np.isscalar(val):
            out[v.name] = np.array(val, copy=True)
    event = None
    if on_card:
        event = torch.cuda.Event()
        event.record()
    return out, event


def _pickle_value(v):
    """A bundle value as the pickle backend stores it: numpy, bf16 as an
    ml_dtypes array (the JAX package's type) where ml_dtypes is installed,
    else a CPU torch tensor."""
    if not isinstance(v, torch.Tensor):
        return np.asarray(v)
    if v.dtype == torch.uint16:
        return v.view(torch.int16).numpy().view(np.uint16)
    if v.dtype == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError:
            return v
        return v.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return v.numpy()


def _as_tensor(v) -> torch.Tensor:
    """A loaded bundle value as a CPU tensor (numpy, an ml_dtypes bf16
    array, or a tensor the native reader or pickle returned)."""
    if isinstance(v, torch.Tensor):
        return v
    return from_numpy(np.asarray(v))


def _text(v) -> str:
    """A string entry as written (backends round-trip it as a 0-d or
    1-element array)."""
    return "".join(str(x) for x in np.asarray(v).ravel())


def _write_bytes(path: str, blob: bytes) -> Tuple[str, int]:
    """Write + fsync `blob` to `path`; returns (sha256 hex, size). The
    fsync keeps the manifest honest: once the hash is recorded the bytes
    it covers are durable, so a post-rename power loss can't produce a
    file that passes size checks but reads back zeros."""
    with open(path, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    return hashlib.sha256(blob).hexdigest(), len(blob)


def _hash_file(path: str) -> Tuple[str, int]:
    h = hashlib.sha256()
    size = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
            size += len(chunk)
    return h.hexdigest(), size


class Checkpointer:
    """`Checkpointer(dirname).save(step)` / `.restore()` over a Program's
    persistables. One background writer thread; `wait()` joins it.

    After a successful `restore()`, ``last_extra`` holds any ``@dataio@*``
    keys the checkpoint carried (input-pipeline cursors that
    ``save(extra=...)`` stored, e.g. ``DeviceLoader.state()``)."""

    def __init__(self, dirname: str, keep: int = 3):
        self.dirname = dirname
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        # (exception, step, path, attempts) of a failed background write
        self._error: Optional[tuple] = None
        self._current_path: Optional[str] = None
        self.last_extra: Dict[str, object] = {}
        # ms the last committed background write took (copies + write)
        self.last_write_ms: Optional[float] = None
        os.makedirs(dirname, exist_ok=True)

    def _path(self, step: int) -> str:
        # native bundle when the C++ writer is available, else pickle
        from ..native import available as _native_available
        ext = "ptck" if _native_available() else "pkl"
        return os.path.join(self.dirname, f"ckpt-{step}.{ext}")

    def _existing_path(self, step: int) -> Optional[str]:
        for ext in ("ptck", "pkl"):
            p = os.path.join(self.dirname, f"ckpt-{step}.{ext}")
            if os.path.exists(p):
                return p
        return None

    def _manifest_path(self, step: int, rank) -> str:
        return os.path.join(self.dirname, f"ckpt-{step}.manifest-{rank}.json")

    # -- background write --------------------------------------------------
    def _write(self, step: int, vals: Dict[str, object], event=None):
        """Writer-thread entry: wait for the snapshot's copies, then write,
        retrying transient I/O with capped exponential backoff; any
        residual failure is surfaced by the next wait()/save() (a silently
        lost checkpoint must not look durable)."""
        retries = int(os.environ.get("PDTPU_CKPT_RETRIES", "3"))
        backoff_ms = float(os.environ.get("PDTPU_CKPT_RETRY_BACKOFF_MS",
                                          "100"))
        attempt = 0
        t0 = time.perf_counter()
        try:
            if event is not None:
                event.synchronize()  # the D2H copies have landed
        except BaseException as e:
            self._error = (e, step, None, attempt)
            return
        while True:
            try:
                self._write_impl(step, vals)
                self.last_write_ms = (time.perf_counter() - t0) * 1e3
                _WRITE_MS.observe(self.last_write_ms)
                return
            except OSError as e:
                # transient filesystem error (NFS blip, EIO, injected
                # fault): every tmp-write/rename in _write_impl is
                # idempotent, so the whole write can simply run again
                path = getattr(e, "filename", None) or self._current_path
                if attempt >= retries:
                    self._error = (e, step, path, attempt)
                    return
                _RETRIES.inc()
                time.sleep(min(backoff_ms * (2 ** attempt), 5000.0) / 1e3)
                attempt += 1
            except BaseException as e:
                self._error = (e, step, self._current_path, attempt)
                return

    def _write_manifest(self, step: int, rank, manifest: Dict[str, dict]):
        """The commit record: written LAST, after every file it hashes is
        durable under its final name. A step without its manifests is an
        uncommitted (or pre-manifest legacy) checkpoint."""
        mpath = self._manifest_path(step, rank)
        self._current_path = mpath
        blob = json.dumps({"step": step, "rank": rank, "files": manifest},
                          sort_keys=True).encode("utf-8")
        _write_bytes(mpath + ".tmp", blob)
        os.replace(mpath + ".tmp", mpath)

    def _write_impl(self, step: int, vals: Dict[str, object]):
        """One process writes rank 0's files: the bundle, its manifest and
        the marker (a JAX mesh run's per-rank shard files are read by
        `_assemble_shards`; writing them comes with ROADMAP A9)."""
        manifest: Dict[str, dict] = {}
        path = self._path(step)
        tmp = path + ".tmp"
        self._current_path = path
        written = False
        if path.endswith(".ptck"):
            # native framed writer (src/ckptio.cc — save_combine_op.cc
            # analog): buffered stdio + fsync; bf16 rides as a uint16 view
            from ..native import write_bundle
            nb = dict(vals)
            nb["@step@"] = np.asarray(step, np.int64)
            if write_bundle(tmp, nb):
                digest, size = _hash_file(tmp)
                written = True
            else:
                # honor write_bundle's documented contract: fall back to
                # pickle rather than losing the checkpoint
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                path = os.path.join(self.dirname, f"ckpt-{step}.pkl")
                tmp = path + ".tmp"
                self._current_path = path
        if not written:
            bundle = {n: _pickle_value(v) for n, v in vals.items()}
            digest, size = _write_bytes(
                tmp, pickle.dumps({"step": step, "vars": bundle},
                                  protocol=4))
        manifest[os.path.basename(path)] = {"sha256": digest, "bytes": size}
        fault_point("ckpt.bundle_write", path=tmp)
        os.replace(tmp, path)  # atomic: never a half-written ckpt-N
        fault_point("ckpt.rename", path=path)
        self._write_manifest(step, 0, manifest)
        marker = os.path.join(self.dirname, "latest")
        self._current_path = marker
        _write_bytes(marker + ".tmp", str(step).encode("ascii"))
        fault_point("ckpt.marker", path=marker + ".tmp")
        os.replace(marker + ".tmp", marker)
        self._gc(step)

    def _gc(self, newest: int):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep] if self.keep else []:
            if s != newest:
                p = self._existing_path(s)
                if p:
                    try:
                        os.remove(p)
                    except OSError:
                        pass
                for f in os.listdir(self.dirname):
                    if (f.startswith(f"ckpt-{s}.shards-")
                            or f.startswith(f"ckpt-{s}.index-")
                            or f.startswith(f"ckpt-{s}.manifest-")
                            or f.startswith(f"delta-{s}-")):
                        try:
                            os.remove(os.path.join(self.dirname, f))
                        except OSError:
                            pass

    def all_steps(self):
        out = []
        for f in os.listdir(self.dirname):
            if f.startswith("ckpt-") and (f.endswith(".pkl")
                                          or f.endswith(".ptck")):
                try:
                    out.append(int(f[5:].rsplit(".", 1)[0]))
                except ValueError:
                    pass
        return out

    def latest_step(self) -> Optional[int]:
        marker = os.path.join(self.dirname, "latest")
        if os.path.exists(marker):
            s = None
            try:
                with open(marker) as f:
                    s = int(f.read().strip())
            except (ValueError, OSError):
                # empty or torn marker (crash between open and the rename,
                # or a pre-fsync power loss): fall back to the dir scan
                pass
            if s is not None and self._existing_path(s):
                return s
        steps = self.all_steps()
        return max(steps) if steps else None

    # -- integrity ---------------------------------------------------------
    def verify(self, step: int) -> List[str]:
        """Check every file the step's manifests list (existence, size,
        SHA-256). Returns [] when the step verifies. A step with no
        manifest at all (pre-manifest legacy writer, or a crash after the
        bundle rename but before the commit record) has nothing to check
        against and is trusted as-is — its bundle rename was atomic."""
        problems: List[str] = []
        prefix = f"ckpt-{step}.manifest-"
        for fname in sorted(os.listdir(self.dirname)):
            if not (fname.startswith(prefix) and fname.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.dirname, fname)) as f:
                    listed = json.load(f)["files"]
            except (OSError, ValueError, KeyError) as e:
                problems.append(f"{fname}: unreadable manifest "
                                f"({type(e).__name__}: {e})")
                continue
            for base, ent in sorted(listed.items()):
                p = os.path.join(self.dirname, base)
                try:
                    size = os.path.getsize(p)
                except OSError:
                    problems.append(
                        f"{base}: listed in manifest {fname} but missing")
                    continue
                if int(ent.get("bytes", -1)) != size:
                    problems.append(
                        f"{base}: size {size} != manifest's "
                        f"{ent.get('bytes')} (torn write)")
                    continue
                digest, _ = _hash_file(p)
                if digest != ent.get("sha256"):
                    problems.append(
                        f"{base}: sha256 mismatch vs manifest {fname} "
                        "(corrupt)")
        return problems

    # -- PS tables (ROADMAP A8) --------------------------------------------
    def save_delta(self, step: int, ps_tables, extra=None,
                   blocking: bool = False) -> None:
        raise NotImplementedError(f"Checkpointer.save_delta: {_PS_TODO}")

    def load_ps_table(self, tname: str, table=None):
        raise NotImplementedError(f"Checkpointer.load_ps_table: {_PS_TODO}")

    # -- save --------------------------------------------------------------
    def save(self, step: int, program: Optional[Program] = None,
             scope: Optional[Scope] = None, blocking: bool = False,
             extra: Optional[Dict[str, object]] = None,
             ps_tables: Optional[Dict[str, object]] = None):
        """Snapshot now, write in the background (orbax async-save shape).

        The snapshot's D2H copies run on the current stream in stream
        order (so the next step's in-place updates cannot reach them);
        `save` returns without waiting for them or for the write.

        `extra` rides in the bundle verbatim (numpy-converted) — e.g.
        ``@dataio@*`` input-pipeline cursors. Keys should start with ``@``
        so they can never collide with a program variable."""
        if ps_tables:
            raise NotImplementedError(f"Checkpointer.save: {_PS_TODO}")
        program = program or default_main_program()
        scope = scope or _scope()
        self.wait()  # one write in flight at a time
        vals, event = _snapshot(program, scope)
        rng = scope.find_var(_RNG_STATE)
        if isinstance(rng, torch.Generator):
            vals["@rng@"] = rng.get_state().numpy()
            vals["@rng_impl@"] = np.asarray(f"torch:{rng.device.type}")
        for k, v in (extra or {}).items():
            vals[k] = np.asarray(v)
        self._thread = threading.Thread(
            target=self._write, args=(step, vals, event), daemon=True,
            name="pdtpu-ckpt-writer")
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        """Join the in-flight write; re-raises a writer failure naming the
        step and the failing path (a silently lost checkpoint must not
        look durable)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            (err, step, path, attempts), self._error = self._error, None
            where = f" (path {path!r})" if path else ""
            tried = (f" after {attempts + 1} attempts"
                     if isinstance(err, OSError) and attempts else "")
            raise RuntimeError(
                f"checkpoint write failed at step {step}{where}{tried}"
            ) from err

    # -- restore -----------------------------------------------------------
    def _assemble_shards(self, step: int) -> Dict[str, np.ndarray]:
        """Merge every rank's shard files into full host arrays: works
        under ANY process count on restore (a checkpoint a JAX mesh run
        wrote restores here). Missing coverage raises instead of returning
        silently-partial parameters."""
        out: Dict[str, np.ndarray] = {}
        placed: Dict[str, int] = {}
        for fname in sorted(os.listdir(self.dirname)):
            if not (fname.startswith(f"ckpt-{step}.index-")
                    and fname.endswith(".json")):
                continue
            rank = fname[len(f"ckpt-{step}.index-"):-len(".json")]
            with open(os.path.join(self.dirname, fname)) as f:
                index = json.load(f)
            spath = os.path.join(self.dirname,
                                 f"ckpt-{step}.shards-{rank}.pkl")
            with open(spath, "rb") as f:
                data = pickle.load(f)
            for name, ent in index.items():
                if name not in out:
                    out[name] = np.empty(tuple(ent["shape"],),
                                         dtype=ent["dtype"])
                    placed[name] = 0
                for sh in ent["shards"]:
                    sl = tuple(slice(a, b) for a, b in sh["bounds"])
                    piece = data[sh["key"]]
                    out[name][sl] = piece
                    placed[name] += int(piece.size)
        for name, arr in out.items():
            if placed[name] < arr.size:
                raise RuntimeError(
                    f"checkpoint step {step}: sharded var {name!r} has only "
                    f"{placed[name]}/{arr.size} elements across the rank "
                    f"index files — a rank's shard file is missing")
        return out

    def _load_step(self, step: int, path: str, program: Program):
        """Read + assemble one checkpoint WITHOUT touching the scope: any
        read error or shard-coverage gap surfaces here, before a single
        var is mutated, so the fallback walk never leaves the scope
        half-restored."""
        if path.endswith(".ptck"):
            from ..native import read_bundle
            bundle = read_bundle(path)
            if bundle is None:
                raise RuntimeError(f"cannot read native checkpoint {path}")
            bundle.pop("@step@", None)
            vars_ = bundle
        else:
            with open(path, "rb") as f:
                vars_ = pickle.load(f)["vars"]
        names = {v.name for v in program.list_vars() if v.persistable}
        manifest_raw = vars_.pop("@shard_manifest@", None)
        if vars_.pop("@ps_manifest@", None) is not None:
            raise RuntimeError(f"checkpoint step {step} holds PS tables: "
                               f"{_PS_TODO}")
        assembled = self._assemble_shards(step)
        if manifest_raw is not None:
            # backends may round-trip the string as a 0-d or 1-element
            # array
            raw = np.asarray(manifest_raw).ravel()
            expected = set("\n".join(str(x) for x in raw).split("\n"))
            missing = sorted((expected & names) - set(assembled))
            if missing:
                raise RuntimeError(
                    f"checkpoint step {step}: sharded vars {missing} are in "
                    "the save-time manifest but absent from every rank's "
                    "index file — a rank's shard/index files are missing "
                    "(e.g. crash between rank-0's marker write and that "
                    "rank's background shard write)")
        to_set = {n: _as_tensor(a) for n, a in vars_.items() if n in names}
        to_set.update({n: _as_tensor(a) for n, a in assembled.items()
                       if n in names})
        rng = None
        if "@rng@" in vars_:  # resume the random stream too
            impl = vars_.get("@rng_impl@")
            kind = (_text(impl) if impl is not None
                    else f"a JAX key ({np.asarray(vars_['@rng@']).dtype})")
            rng = (kind, np.asarray(vars_["@rng@"]))
        extra = {k: v for k, v in vars_.items() if k.startswith("@dataio@")}
        return to_set, rng, extra

    def _restore_rng(self, scope: Scope, rng, device: torch.device):
        kind, raw = rng
        want = f"torch:{device.type}"
        if kind != want:
            warnings.warn(
                f"checkpoint in {self.dirname!r}: its random state is "
                f"{kind}, this restore runs a {want} generator; every "
                f"variable was loaded and the scope's generator was left "
                f"as it is", RuntimeWarning)
            return
        gen = torch.Generator(device)
        gen.set_state(torch.from_numpy(np.ascontiguousarray(
            raw.astype(np.uint8, copy=False))))
        scope.set_var(_RNG_STATE, gen)

    @staticmethod
    def _place_value(scope: Scope, name: str, val: torch.Tensor,
                     device: torch.device):
        """Set one restored value: in place into a same-shape, same-dtype
        tensor already on `device`, else as a new tensor there."""
        cur = scope.find_var(name)
        if (isinstance(cur, torch.Tensor) and cur.device == device
                and cur.dtype == val.dtype and cur.shape == val.shape):
            if cur.dtype == torch.uint16:
                cur.view(torch.int16).copy_(val.view(torch.int16))
            else:
                cur.copy_(val)
            return
        scope.set_var(name, to_device(val, device))

    def restore(self, step: Optional[int] = None,
                program: Optional[Program] = None,
                scope: Optional[Scope] = None,
                ps_tables: Optional[Dict[str, object]] = None,
                place=None) -> Optional[int]:
        """Load a checkpoint into the scope, on `place` (``CUDAPlace(0)``
        unless the caller passes another place, ``CPUPlace()`` for the
        CPU).

        With ``step=None`` the newest checkpoint that passes integrity
        verification wins: a corrupt/torn candidate is skipped with a
        warning naming the bad files (``checkpoint/fallback_steps``
        counter), and the walk continues to older steps. Only when EVERY
        candidate fails does restore raise. An explicit ``step`` is loaded
        or fails — no silent substitution."""
        if ps_tables:
            raise NotImplementedError(f"Checkpointer.restore: {_PS_TODO}")
        device = (place or CUDAPlace(0)).torch_device()
        program = program or default_main_program()
        scope = scope or _scope()
        self.wait()
        self.last_extra = {}
        if step is not None:
            candidates = [step]
        else:
            candidates = sorted(set(self.all_steps()), reverse=True)
        failures: List[str] = []
        for st in candidates:
            path = self._existing_path(st)
            if path is None:
                continue
            bad = self.verify(st)
            loaded = None
            if not bad:
                try:
                    loaded = self._load_step(st, path, program)
                except (RuntimeError, OSError, EOFError, ValueError,
                        pickle.UnpicklingError) as e:
                    bad = [f"{os.path.basename(path)}: "
                           f"{type(e).__name__}: {e}"]
            if bad:
                desc = "; ".join(bad)
                failures.append(f"step {st}: {desc}")
                _FALLBACK.inc()
                warnings.warn(
                    f"checkpoint step {st} in {self.dirname!r} failed "
                    f"integrity verification ({desc}); falling back to the "
                    "next older checkpoint", RuntimeWarning)
                continue
            to_set, rng, extra = loaded
            for n, val in to_set.items():
                self._place_value(scope, n, val, device)
            if rng is not None:
                self._restore_rng(scope, rng, device)
            self.last_extra = extra
            return st
        if failures:
            raise RuntimeError(
                f"no verifiable checkpoint in {self.dirname!r}; every "
                "candidate failed integrity verification: "
                + " | ".join(failures))
        return None


def save_checkpoint(dirname: str, step: int, program=None, scope=None,
                    blocking: bool = True):
    ck = Checkpointer(dirname)
    ck.save(step, program=program, scope=scope, blocking=blocking)
    return ck


def load_checkpoint(dirname: str, program=None, scope=None,
                    step: Optional[int] = None, place=None):
    return Checkpointer(dirname).restore(step, program=program, scope=scope,
                                         place=place)
