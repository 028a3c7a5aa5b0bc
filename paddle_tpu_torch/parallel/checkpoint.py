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

PS tables. ``save(ps_tables={name: ShardedTable})`` runs each table's
flush hook (the tier writes back the hot slab's dirty rows and drains its
pusher), takes the table's push-journal mark, and dumps every shard into
the per-rank shard files under ``<name>@ps`` with the mark as
``@ps_mark@<name>``; the journal is truncated to the mark once the save
commits. `save_delta` persists only the journal entries since the chain
head (``delta-<base>-<step>.pkl`` + manifest); `restore(ps_tables=)`
assembles the newest verified full save, replays its verified delta chain
and re-partitions the table onto the LIVE shard count; `load_ps_table` is
the same read for shard recovery. The files are the JAX package's, both
ways.

Not ported here: writing sharded tensors (ROADMAP A9).

Chaos probes (``faults``): ``ckpt.bundle_write``, ``ckpt.rename``,
``ckpt.shard_write``, ``ckpt.delta_write`` and ``ckpt.marker`` sit at
every commit edge.
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
        # incremental-checkpoint chain head: the committed full save (or
        # restore) deltas extend — {"step": int, "marks": {table: mark}}.
        # Advanced only by on-commit callbacks / restore, so an aborted
        # write never becomes a delta base.
        self._ps_base: Optional[Dict[str, object]] = None
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
    def _write(self, step: int, vals: Dict[str, object], event=None,
               shards=(), on_commit=()):
        """Writer-thread entry: wait for the snapshot's copies, then write,
        retrying transient I/O with capped exponential backoff; any
        residual failure is surfaced by the next wait()/save() (a silently
        lost checkpoint must not look durable). `on_commit` callbacks run
        only after the write fully commits (manifest + marker durable) —
        e.g. PS journal truncation, which must never happen for a
        checkpoint that might not be restorable."""
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
                self._write_impl(step, vals, shards)
                self.last_write_ms = (time.perf_counter() - t0) * 1e3
                _WRITE_MS.observe(self.last_write_ms)
                for cb in on_commit:
                    try:
                        cb()
                    except Exception:
                        pass  # commit stands; truncation is best-effort
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

    def _write_shards(self, step: int, shards, rank: int,
                      manifest: Dict[str, dict]):
        """Per-process shard file + JSON index, both fsync+rename-durable
        and recorded in `manifest`. Each process writes ONLY its
        addressable replica-0 shards; restore merges every rank's index
        (shared-filesystem contract, same as the reference's save_combine
        to a common dirname)."""
        data = {}
        index: Dict[str, dict] = {}
        for name, bounds, shape, dtype, buf in shards:
            key = f"{name}@" + ",".join(f"{a}:{b}" for a, b in bounds)
            data[key] = np.asarray(buf)
            ent = index.setdefault(name, {"shape": list(shape),
                                          "dtype": dtype, "shards": []})
            ent["shards"].append({"key": key,
                                  "bounds": [list(b) for b in bounds]})
        spath = os.path.join(self.dirname, f"ckpt-{step}.shards-{rank}.pkl")
        self._current_path = spath
        digest, size = _write_bytes(spath + ".tmp",
                                    pickle.dumps(data, protocol=4))
        manifest[os.path.basename(spath)] = {"sha256": digest, "bytes": size}
        fault_point("ckpt.shard_write", path=spath + ".tmp")
        os.replace(spath + ".tmp", spath)
        ipath = os.path.join(self.dirname, f"ckpt-{step}.index-{rank}.json")
        self._current_path = ipath
        digest, size = _write_bytes(ipath + ".tmp",
                                    json.dumps(index).encode("utf-8"))
        manifest[os.path.basename(ipath)] = {"sha256": digest, "bytes": size}
        os.replace(ipath + ".tmp", ipath)

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

    def _write_impl(self, step: int, vals: Dict[str, object], shards=()):
        """One process writes rank 0's files: the PS tables' shard file
        and index, the bundle, its manifest and the marker (a JAX mesh
        run's per-rank shard files of sharded tensors are read by
        `_assemble_shards`; writing those comes with ROADMAP A9)."""
        manifest: Dict[str, dict] = {}
        if shards:
            self._write_shards(step, shards, 0, manifest)
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

    def verified_steps(self) -> List[int]:
        """Every step whose manifest verification passes, newest first:
        the set a serving ModelRegistry may claim lineage from (a torn or
        corrupt training checkpoint never becomes a serving version)."""
        return [s for s in sorted(self.all_steps(), reverse=True)
                if not self.verify(s)]

    # -- incremental (delta) checkpoints ------------------------------------
    def _delta_path(self, base: int, dstep: int) -> str:
        return os.path.join(self.dirname, f"delta-{base}-{dstep}.pkl")

    def _delta_manifest_path(self, base: int, dstep: int) -> str:
        return os.path.join(self.dirname,
                            f"delta-{base}-{dstep}.manifest.json")

    def delta_steps(self, base: int) -> List[int]:
        """Delta steps on disk anchored to full checkpoint `base`,
        ascending (the chain replay order)."""
        out = []
        prefix = f"delta-{base}-"
        for f in os.listdir(self.dirname):
            if f.startswith(prefix) and f.endswith(".pkl"):
                try:
                    out.append(int(f[len(prefix):-len(".pkl")]))
                except ValueError:
                    pass
        return sorted(out)

    def verify_delta(self, base: int, dstep: int) -> List[str]:
        """Manifest check (existence, size, SHA-256) for one delta file;
        [] when it verifies. A delta with no manifest is uncommitted."""
        problems: List[str] = []
        mpath = self._delta_manifest_path(base, dstep)
        try:
            with open(mpath) as f:
                listed = json.load(f)["files"]
        except (OSError, ValueError, KeyError) as e:
            return [f"{os.path.basename(mpath)}: unreadable manifest "
                    f"({type(e).__name__}: {e})"]
        for bname, ent in sorted(listed.items()):
            p = os.path.join(self.dirname, bname)
            try:
                size = os.path.getsize(p)
            except OSError:
                problems.append(f"{bname}: listed in manifest but missing")
                continue
            if int(ent.get("bytes", -1)) != size:
                problems.append(f"{bname}: size {size} != manifest's "
                                f"{ent.get('bytes')} (torn write)")
                continue
            digest, _ = _hash_file(p)
            if digest != ent.get("sha256"):
                problems.append(f"{bname}: sha256 mismatch (corrupt)")
        return problems

    def _delta_chain(self, base: int) -> List[dict]:
        """The longest verifiable prefix of `base`'s delta chain, as
        loaded payload dicts in ascending delta-step order. The walk
        stops at the first unverifiable/unreadable file: every delta
        after a hole is built over state the restore cannot reconstruct,
        so applying it would be silently lossy."""
        chain: List[dict] = []
        for ds in self.delta_steps(base):
            bad = self.verify_delta(base, ds)
            payload = None
            if not bad:
                try:
                    with open(self._delta_path(base, ds), "rb") as f:
                        payload = pickle.load(f)
                except (OSError, EOFError, ValueError,
                        pickle.UnpicklingError) as e:
                    bad = [f"{type(e).__name__}: {e}"]
            if bad:
                warnings.warn(
                    f"delta checkpoint {base}->{ds} in {self.dirname!r} "
                    f"failed verification ({'; '.join(bad)}); stopping the "
                    "delta replay chain here", RuntimeWarning)
                _FALLBACK.inc()
                break
            chain.append(payload)
        return chain

    @staticmethod
    def _apply_delta_chain(chain: List[dict], tname: str,
                           rows: np.ndarray, mark: int):
        """Replay one table's entries from an already-verified chain onto
        the dense `rows` array, in delta order then seq order (scatter-SET
        of absolute rows ⇒ ordered replay is bitwise-exact). Stops at a
        mark discontinuity (a delta whose ``since_mark`` doesn't extend
        the state we hold). Returns (rows, final_mark, deltas_applied)."""
        applied = 0
        for payload in chain:
            blob = (payload.get("tables") or {}).get(tname)
            if blob is None:
                continue
            if int(blob["since_mark"]) != int(mark):
                break
            off = 0
            ids = np.asarray(blob["ids"], np.int64)
            drows = np.asarray(blob["rows"], np.uint16)
            for c in np.asarray(blob["counts"], np.int64).tolist():
                rows[ids[off:off + c]] = drows[off:off + c]
                off += c
            mark = int(blob["mark"])
            applied += 1
        return rows, mark, applied

    def save_delta(self, step: int, ps_tables: Dict[str, object],
                   extra: Optional[Dict[str, object]] = None,
                   blocking: bool = False) -> None:
        """Incremental PS checkpoint: persist only the rows touched since
        the chain head — the journal entries past the last full save's
        (or previous delta's) mark — as ``delta-<base>-<step>.pkl`` plus
        a SHA-256 manifest, committed tmp→fsync→rename like everything
        else. Orders of magnitude smaller than a full dump for a big
        table, so it can run every few seconds on an online trainer.

        Riding the push journal: each table's flush hook runs
        first (device-dirty rows + queued async pushes land in the
        journal), the snapshot is the journal slice ``(since_mark,
        mark]``, and the journal is truncated to `mark` once — and only
        once — the delta COMMITS, which is what keeps journal memory
        bounded by delta cadence on an unbounded stream.

        Requires a committed full ``save(ps_tables=...)`` (or a
        ``restore``) as the chain base; ``save()`` is the compaction
        point — it rewrites the whole table and starts a fresh chain.
        Restore replays: newest verified full + its chain in order,
        bitwise-exact (see ``restore``/``load_ps_table``)."""
        if not ps_tables:
            raise ValueError("save_delta: ps_tables is required (a delta "
                             "checkpoint IS the PS-table increment)")
        self.wait()  # one write in flight at a time; surfaces prior errors
        base = self._ps_base
        if base is None:
            raise RuntimeError(
                "save_delta: no committed full checkpoint to anchor the "
                "delta chain — call save(ps_tables=...) (or restore) first")
        base_step = int(base["step"])
        marks: Dict[str, int] = dict(base["marks"])  # type: ignore[arg-type]
        tables_blob: Dict[str, dict] = {}
        on_commit = []
        for tname, table in ps_tables.items():
            hook = getattr(table, "flush_hook", None)
            if hook is not None:
                hook()
            since = int(marks.get(tname, 0))
            mark = int(table.journal_mark())
            entries = [e for e in table.journal_entries_since(since)
                       if e[0] <= mark]
            lanes = int(table.lanes)
            if entries:
                ids = np.concatenate([e[1] for e in entries])
                rows = np.concatenate([e[2] for e in entries], axis=0)
            else:
                ids = np.zeros((0,), np.int64)
                rows = np.zeros((0, lanes), np.uint16)
            tables_blob[tname] = {
                "since_mark": since, "mark": mark,
                "seqs": np.asarray([e[0] for e in entries], np.int64),
                "counts": np.asarray([e[1].shape[0] for e in entries],
                                     np.int64),
                "ids": ids, "rows": rows, "lanes": lanes,
                "vocab": int(table.spec.vocab),
            }
            marks[tname] = mark
            on_commit.append(lambda t=table, m=mark: t.journal_truncate(m))
        on_commit.append(lambda s=base_step, m=dict(marks):
                         self._set_ps_base(s, m))
        vals = {k: np.asarray(v) for k, v in (extra or {}).items()}
        self._thread = threading.Thread(
            target=self._write_delta,
            args=(base_step, int(step), tables_blob, vals, on_commit),
            daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _write_delta(self, base_step: int, step: int, tables_blob: dict,
                     vals: dict, on_commit=()):
        """Writer-thread entry for a delta (same retry/commit contract as
        `_write`: manifest last, on_commit only after it is durable)."""
        retries = int(os.environ.get("PDTPU_CKPT_RETRIES", "3"))
        backoff_ms = float(os.environ.get("PDTPU_CKPT_RETRY_BACKOFF_MS",
                                          "100"))
        attempt = 0
        while True:
            try:
                payload = {"base_step": base_step, "step": step,
                           "tables": tables_blob, "extra": vals}
                path = self._delta_path(base_step, step)
                self._current_path = path
                manifest: Dict[str, dict] = {}
                digest, size = _write_bytes(
                    path + ".tmp", pickle.dumps(payload, protocol=4))
                manifest[os.path.basename(path)] = {"sha256": digest,
                                                    "bytes": size}
                fault_point("ckpt.delta_write", path=path + ".tmp")
                os.replace(path + ".tmp", path)
                mpath = self._delta_manifest_path(base_step, step)
                self._current_path = mpath
                blob = json.dumps({"step": step, "base_step": base_step,
                                   "files": manifest},
                                  sort_keys=True).encode("utf-8")
                _write_bytes(mpath + ".tmp", blob)
                os.replace(mpath + ".tmp", mpath)
                for cb in on_commit:
                    try:
                        cb()
                    except Exception:
                        pass  # commit stands; truncation is best-effort
                return
            except OSError as e:
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

    def _set_ps_base(self, step: int, marks: Dict[str, int]) -> None:
        self._ps_base = {"step": int(step),
                         "marks": {k: int(v) for k, v in marks.items()}}

    def load_ps_table(self, tname: str):
        """Shard-recovery read path: ``(full_rows, journal_mark, step)``
        for PS table `tname` from the newest checkpoint that passes
        integrity verification. Touches no scope and needs no Program —
        it is called from inside the tier's pull/push threads while the
        training loop is blocked on the dead shard. Deliberately does NOT
        ``wait()`` on an in-flight save: an uncommitted step has no
        manifest yet and simply isn't a candidate."""
        psn = f"{tname}@ps"
        failures: List[str] = []
        for st in sorted(set(self.all_steps()), reverse=True):
            path = self._existing_path(st)
            if path is None:
                continue
            bad = self.verify(st)
            if not bad:
                try:
                    if path.endswith(".ptck"):
                        from ..native import read_bundle
                        bundle = read_bundle(path)
                        if bundle is None:
                            raise RuntimeError(
                                f"cannot read native checkpoint {path}")
                    else:
                        with open(path, "rb") as f:
                            bundle = pickle.load(f)["vars"]
                    assembled = self._assemble_shards(st)
                    if psn not in assembled:
                        raise RuntimeError(f"no {psn!r} shards")
                    mark = int(np.asarray(
                        bundle.get(f"@ps_mark@{tname}", 0)).reshape(()))
                    # replay the verified delta chain: a shard recovered
                    # mid-stream gets full ∘ deltas, and the returned mark
                    # is the last delta's so the client replays only the
                    # journal tail past it
                    rows, mark, _ = self._apply_delta_chain(
                        self._delta_chain(st), tname, assembled[psn], mark)
                    return rows, mark, st
                except (RuntimeError, OSError, EOFError, ValueError,
                        pickle.UnpicklingError) as e:
                    bad = [f"{type(e).__name__}: {e}"]
            failures.append(f"step {st}: {'; '.join(bad)}")
            _FALLBACK.inc()
        raise RuntimeError(
            f"ps recovery: no verifiable checkpoint holding table "
            f"{tname!r} in {self.dirname!r}"
            + (f" ({' | '.join(failures)})" if failures else
               " (no checkpoints at all — save one before training so a "
               "restarted shard has a recovery base)"))

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
        so they can never collide with a program variable.

        `ps_tables` ({table_name: ps.ShardedTable}) adds the PS embedding
        tier's shards to the shard file + manifest path: each table's
        flush hook runs first (the tier writes back the hot slab's dirty
        rows and drains its pusher), then each shard's slice is dumped NOW
        under the ``<name>@ps`` key, one record per shard. The table's
        push journal mark rides along as ``@ps_mark@<name>`` (read back by
        shard recovery) and the journal is truncated to it once — and
        only once — this checkpoint COMMITS."""
        program = program or default_main_program()
        scope = scope or _scope()
        self.wait()  # one write in flight at a time
        vals, event = _snapshot(program, scope)
        shards = []
        ps_names = []
        on_commit = []
        ps_marks_now: Dict[str, int] = {}
        for tname, table in (ps_tables or {}).items():
            psn = f"{tname}@ps"
            ps_names.append(psn)
            spec, lanes = table.spec, table.lanes
            hook = getattr(table, "flush_hook", None)
            if hook is not None:
                # flush-before-save: the mark taken below covers every
                # update the dumps contain
                hook()
            if hasattr(table, "journal_mark"):
                # mark BEFORE the dumps: an entry with seq <= mark was
                # applied before the flush, so the dumped bytes contain
                # it; a racing push lands at seq > mark and stays
                # journaled (replay is idempotent either way)
                mark = int(table.journal_mark())
                vals[f"@ps_mark@{tname}"] = np.asarray(mark, np.int64)
                ps_marks_now[tname] = mark
                on_commit.append(
                    lambda t=table, m=mark: t.journal_truncate(m))
            for i in range(spec.num_shards):
                lo, hi = spec.bounds(i)
                shards.append((psn, ((lo, hi), (0, lanes)),
                               (spec.vocab, lanes), "uint16",
                               table.dump_shard(i)))
        if ps_names:
            # a committed full save is the new delta-chain head (the
            # compaction point): subsequent save_delta() calls extend it
            on_commit.append(lambda s=int(step), m=dict(ps_marks_now):
                             self._set_ps_base(s, m))
            # restore-side coverage check: which PS tables this
            # checkpoint is supposed to contain
            vals["@ps_manifest@"] = np.asarray("\n".join(sorted(ps_names)))
        rng = scope.find_var(_RNG_STATE)
        if isinstance(rng, torch.Generator):
            vals["@rng@"] = rng.get_state().numpy()
            vals["@rng_impl@"] = np.asarray(f"torch:{rng.device.type}")
        for k, v in (extra or {}).items():
            vals[k] = np.asarray(v)
        self._thread = threading.Thread(
            target=self._write, args=(step, vals, event, shards, on_commit),
            daemon=True, name="pdtpu-ckpt-writer")
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
        ps_manifest_raw = vars_.pop("@ps_manifest@", None)
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
        if ps_manifest_raw is not None:
            raw = np.asarray(ps_manifest_raw).ravel()
            expected_ps = set("\n".join(_text(x) for x in raw).split("\n"))
            missing_ps = sorted(expected_ps - set(assembled))
            if missing_ps:
                raise RuntimeError(
                    f"checkpoint step {step}: PS tables {missing_ps} are "
                    "in the save-time manifest but absent from every "
                    "rank's index file — the shard files are missing")
        # `@ps`-suffixed names are never program vars, so the `n in names`
        # filter keeps them out of the scope; they flow back through the
        # fourth return for ShardedTable.load_full
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
        ps_marks = {k[len("@ps_mark@"):]: int(np.asarray(v).reshape(()))
                    for k, v in vars_.items()
                    if k.startswith("@ps_mark@")}
        return to_set, rng, extra, assembled, ps_marks

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
        or fails — no silent substitution.

        `ps_tables` ({table_name: ps.ShardedTable}) restores PS embedding
        shards too: the checkpoint's ``<name>@ps`` slices are assembled
        into the full table, its verified delta chain is replayed onto it,
        and it is re-partitioned onto each table's LIVE range spec —
        restoring onto a different shard count than the save just works.
        Coverage is validated BEFORE the scope or any shard is mutated; a
        candidate missing a requested table falls back like any other
        integrity failure."""
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
            if not bad and loaded is not None and ps_tables:
                # every requested table must be fully present with the
                # right geometry before ANY state mutates
                assembled = loaded[3]
                for tname, table in ps_tables.items():
                    psn = f"{tname}@ps"
                    want = (table.spec.vocab, table.lanes)
                    if psn not in assembled:
                        bad.append(f"PS table {tname!r}: no {psn!r} "
                                   "shards in this checkpoint")
                    elif assembled[psn].shape != want:
                        bad.append(
                            f"PS table {tname!r}: checkpoint shape "
                            f"{assembled[psn].shape} != live {want}")
            if bad:
                desc = "; ".join(bad)
                failures.append(f"step {st}: {desc}")
                _FALLBACK.inc()
                warnings.warn(
                    f"checkpoint step {st} in {self.dirname!r} failed "
                    f"integrity verification ({desc}); falling back to the "
                    "next older checkpoint", RuntimeWarning)
                continue
            to_set, rng, extra, assembled, ps_marks = loaded
            # incremental checkpoints: replay this full save's verified
            # delta chain onto the assembled PS tables BEFORE any state
            # mutates — the restored bytes are full ∘ deltas, bitwise
            # identical to the table at the last committed save_delta
            chain = self._delta_chain(st) if ps_tables else []
            final_marks: Dict[str, int] = {}
            for tname in (ps_tables or {}):
                rows, fmark, _ = self._apply_delta_chain(
                    chain, tname, assembled[f"{tname}@ps"],
                    int(ps_marks.get(tname, 0)))
                assembled[f"{tname}@ps"] = rows
                final_marks[tname] = fmark
            for payload in chain:
                extra.update({k: v for k, v in
                              (payload.get("extra") or {}).items()
                              if k.startswith("@dataio@")})
            for n, val in to_set.items():
                self._place_value(scope, n, val, device)
            if rng is not None:
                self._restore_rng(scope, rng, device)
            for tname, table in (ps_tables or {}).items():
                table.load_full(assembled[f"{tname}@ps"])
                if hasattr(table, "journal_reset"):
                    # the live journal no longer describes deltas over
                    # what was just loaded; re-anchor it at the restored
                    # mark — the last applied delta's, else the full save's
                    table.journal_reset(int(final_marks.get(tname, 0)))
            if ps_tables:
                # restore re-anchors the delta chain: new deltas extend
                # from exactly the state just loaded
                self._set_ps_base(st, final_marks)
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
