"""Atomic, verified checkpoint commit: the synchronous npz path.

Port of the part of deepspeed_tpu/runtime/resilience/atomic.py that a
synchronous save and load need (``savez_hashed``, ``write_manifest``,
``load_manifest``, ``verify_tag``, ``atomic_tag``, ``write_latest``,
``read_latest``), writing the same layout, so that either package loads
the other's tags::

    save_dir/
      latest                  <- plain-text tag name, updated ATOMICALLY last
      global_step10/
        manifest.json         <- per-file {bytes, sha256} + step/world meta
        model_states.npz
        metadata.pkl
      .tmp-global_step20/     <- in-flight write; never trusted by loads

Commit: payload files into ``.tmp-<tag>``; ``manifest.json`` (sizes and
sha256 of every payload file, files above ``CHUNK_BYTES`` hashed as
chunks) written and fsync'd; every payload file and the temp dir fsync'd;
``os.replace(.tmp-<tag>, <tag>)``; the ``latest`` pointer rewritten by
write-temp + fsync + rename. ``verify_tag`` replays the manifest, so a
truncated or corrupted payload is found before it is loaded. Asynchronous
commits, preemption, emergency and suspect tags and tag retention are not
ported (ROADMAP A16).
"""
import hashlib
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from deepspeed_tpu_torch.utils.logging import logger

MANIFEST_NAME = "manifest.json"
MANIFEST_VERSION = 1
LATEST_NAME = "latest"
TMP_PREFIX = ".tmp-"
# files above this are hashed as independent chunks in a thread pool; the
# manifest records the chunk size so verification replays identically
CHUNK_BYTES = 1 << 26


class CheckpointCorrupt(RuntimeError):
    """A tag failed manifest verification."""


def _fsync_path(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _hash_range(path, offset, nbytes):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        f.seek(offset)
        remaining = nbytes
        while remaining > 0:
            block = f.read(min(1 << 20, remaining))
            if not block:
                break
            h.update(block)
            remaining -= len(block)
    return h.digest()


def file_checksum(path):
    return _hash_range(path, 0, os.path.getsize(path)).hex()


def chunked_checksum(path, size=None, chunk_bytes=CHUNK_BYTES):
    """sha256 over the concatenated digests of ``chunk_bytes``-sized
    chunks, hashed in parallel (hashlib releases the GIL)."""
    size = os.path.getsize(path) if size is None else size
    jobs = [(off, min(chunk_bytes, size - off))
            for off in (range(0, size, chunk_bytes) or [0])]
    with ThreadPoolExecutor(min(len(jobs), max(2, os.cpu_count() or 1))) \
            as pool:
        digests = list(pool.map(lambda j: _hash_range(path, *j), jobs))
    outer = hashlib.sha256()
    for d in digests:
        outer.update(d)
    return outer.hexdigest()


def savez_hashed(path, **arrays):
    """np.savez into ``path`` (the manifest pass hashes it)."""
    np.savez(path, **arrays)


def _walk_payload(dirpath):
    """All files under dirpath except the manifest, as relative paths."""
    out = []
    for root, _dirs, names in os.walk(dirpath):
        for name in names:
            rel = os.path.relpath(os.path.join(root, name), dirpath)
            if rel != MANIFEST_NAME:
                out.append(rel)
    return sorted(out)


def write_manifest(dirpath, meta=None, fsync=True):
    """Scan dirpath's files and write manifest.json (sizes + sha256)."""
    files = {}
    for rel in _walk_payload(dirpath):
        full = os.path.join(dirpath, rel)
        size = os.path.getsize(full)
        if size > CHUNK_BYTES:
            files[rel] = {"bytes": size, "chunk_bytes": CHUNK_BYTES,
                          "sha256": chunked_checksum(full, size)}
        else:
            files[rel] = {"bytes": size, "sha256": file_checksum(full)}
    manifest = {"version": MANIFEST_VERSION, "files": files}
    manifest.update(meta or {})
    with open(os.path.join(dirpath, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    return manifest


def load_manifest(tag_dir):
    mpath = os.path.join(tag_dir, MANIFEST_NAME)
    if not os.path.isfile(mpath):
        return None
    try:
        with open(mpath) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        logger.warning(f"unreadable manifest at {mpath}: {e}")
        return None


def verify_tag(tag_dir, check_checksums=True):
    """Replay the manifest against the files; (ok, reason). A tag without a
    manifest verifies as ok with a warning (not protected, still
    loadable)."""
    if not os.path.isdir(tag_dir):
        return False, "missing directory"
    manifest = load_manifest(tag_dir)
    if manifest is None:
        if os.path.isfile(os.path.join(tag_dir, MANIFEST_NAME)):
            return False, "corrupt manifest"
        logger.warning(f"{tag_dir}: no manifest; integrity not verifiable")
        return True, "no manifest"
    files = manifest.get("files", {})
    for rel, want in files.items():
        full = os.path.join(tag_dir, rel)
        if not os.path.isfile(full):
            return False, f"missing file {rel}"
        size = os.path.getsize(full)
        if size != want.get("bytes"):
            return False, (f"size mismatch on {rel}: "
                           f"{size} != {want.get('bytes')}")
        if check_checksums:
            cb = want.get("chunk_bytes")
            digest = chunked_checksum(full, size, chunk_bytes=cb) if cb \
                else file_checksum(full)
            if digest != want.get("sha256"):
                return False, f"checksum mismatch on {rel}"
    extra = set(_walk_payload(tag_dir)) - set(files)
    if extra:
        logger.warning(f"{tag_dir}: unmanifested files present: "
                       f"{sorted(extra)[:4]}")
    return True, "ok"


class atomic_tag:
    """Context manager for one atomic tag write::

        with atomic_tag(save_dir, tag, meta={"global_steps": n}) as tmp:
            ... write payload files into tmp ...

    On a clean exit the tag is committed and fsync'd and the ``latest``
    pointer updated; on an exception the temp dir is removed and save_dir
    is untouched."""

    def __init__(self, save_dir, tag, meta=None, update_latest=True,
                 fsync=True):
        self.save_dir = save_dir
        self.tag = str(tag)
        if "/" in self.tag or os.sep in self.tag or self.tag in ("", ".",
                                                                 ".."):
            raise ValueError(f"checkpoint tag {self.tag!r} must be a single "
                             f"path component")
        self.meta = dict(meta or {})
        self.update_latest = update_latest
        self.fsync = fsync
        self.tmp = os.path.join(save_dir, f"{TMP_PREFIX}{self.tag}")
        self.final = os.path.join(save_dir, self.tag)

    def __enter__(self):
        os.makedirs(self.save_dir, exist_ok=True)
        if os.path.isdir(self.tmp):  # stale tmp from a previous crash
            shutil.rmtree(self.tmp)
        os.makedirs(self.tmp)
        return self.tmp

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)
            return False
        try:
            self._commit()
        except BaseException:
            shutil.rmtree(self.tmp, ignore_errors=True)
            raise
        return False

    def _commit(self):
        self.meta.setdefault("tag", self.tag)
        write_manifest(self.tmp, self.meta, fsync=self.fsync)
        if self.fsync:
            for rel in _walk_payload(self.tmp):
                _fsync_path(os.path.join(self.tmp, rel))
            _fsync_path(self.tmp)
        if os.path.isdir(self.final):
            # an overwritten tag: the old copy is parked, then removed
            doomed = os.path.join(self.save_dir, f"{self.tag}.replaced")
            if os.path.isdir(doomed):
                shutil.rmtree(doomed)
            os.replace(self.final, doomed)
            os.replace(self.tmp, self.final)
            shutil.rmtree(doomed, ignore_errors=True)
        else:
            os.replace(self.tmp, self.final)
        if self.fsync:
            _fsync_path(self.save_dir)
        if self.update_latest:
            write_latest(self.save_dir, self.tag, fsync=self.fsync)


def write_latest(save_dir, tag, fsync=True):
    """Atomically (re)write the 'latest' pointer."""
    tmp = os.path.join(save_dir, f"{TMP_PREFIX}{LATEST_NAME}")
    with open(tmp, "w") as f:
        f.write(str(tag))
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, os.path.join(save_dir, LATEST_NAME))
    if fsync:
        _fsync_path(save_dir)


def read_latest(save_dir):
    path = os.path.join(save_dir, LATEST_NAME)
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return f.read().strip() or None
