"""Atomic, verified checkpoint commits and auto-resume tag selection.

Port of deepspeed_tpu/runtime/resilience/atomic.py, writing the same
layout, so that either package resumes from the other's directory::

    save_dir/
      latest                  <- plain-text tag name, updated ATOMICALLY last
      global_step10/
        manifest.json         <- per-file {bytes, sha256} + step/world meta
        model_states.npz
        metadata.pkl
      .tmp-global_step20/     <- in-flight write; never trusted by loads

Commit: payload files into ``.tmp-<tag>``; ``manifest.json`` (sizes and
sha256 of every payload file, files above ``CHUNK_BYTES`` hashed as
chunks) written and fsync'd; every payload file and the temp dir fsync'd
(``atomic_tag._seal``); ``os.replace(.tmp-<tag>, <tag>)``; the ``latest``
pointer rewritten by write-temp + fsync + rename (``_publish``). A crash
before the rename leaves only a ``.tmp-`` directory (ignored, removed by
``gc_tags``); ``verify_tag`` replays the manifest, so a truncated or
corrupted payload is found before it is loaded. ``PendingCommit`` runs
the seal on a thread and leaves the O(1) publish to the training thread.

The npz payloads are written with fixed zip member timestamps
(``savez_hashed``), so the same state always gives the same bytes and
the same sha256; ``np.load`` reads them as any npz.
"""
import hashlib
import io
import json
import os
import shutil
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from deepspeed_tpu_torch.runtime.resilience import chaos
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


# the zip members' DOS date (1980-01-01) and time (00:00:00): fixed, so
# equal arrays give equal bytes (np.savez stamps the wall clock)
_ZIP_DATE, _ZIP_TIME = (0 << 9) | (1 << 5) | 1, 0
_ZIP_VERSION = 45                      # ZIP64
_ZIP_MAX32, _ZIP_MAX16 = 0xFFFFFFFF, 0xFFFF
# an array's bytes go to the file in slices of this size, straight from
# its buffer
_WRITE_SLICE = 1 << 26


def _npy_member(val):
    """(the .npy header, the data as a flat uint8 view or None): a 0-d or
    object array is all header (np.lib.format's own bytes)."""
    arr = np.asanyarray(val)
    buf = io.BytesIO()
    if arr.ndim == 0 or arr.dtype.hasobject:
        np.lib.format.write_array(buf, arr, allow_pickle=False)
        return buf.getvalue(), None
    arr = np.ascontiguousarray(arr)
    np.lib.format.write_array_header_1_0(
        buf, np.lib.format.header_data_from_array_1_0(arr))
    return buf.getvalue(), arr.reshape(-1).view(np.uint8)


def _member_crc(head, body):
    crc = zlib.crc32(head)
    return crc if body is None else zlib.crc32(body, crc)


def savez_hashed(path, **arrays):
    """The arrays as an npz file (a ZIP64 archive of stored ``.npy``
    members, as ``np.savez`` writes and ``np.load`` reads) with fixed
    member timestamps and every array in C order: the same arrays always
    give the same bytes, so two commits of one state have one sha256.
    The members' CRC-32s are computed in a thread pool (zlib releases the
    GIL) while the file is written; the manifest pass hashes the file."""
    members = [((key + ".npy").encode(),) + _npy_member(val)
               for key, val in arrays.items()]
    central = []
    with ThreadPoolExecutor(max(2, os.cpu_count() or 1)) as pool, \
            open(path, "wb") as f:
        crcs = [pool.submit(_member_crc, head, body)
                for _name, head, body in members]
        for (name, head, body), crc in zip(members, crcs):
            size = len(head) + (0 if body is None else body.size)
            offset = f.tell()
            f.write(struct.pack(
                "<IHHHHHIIIHH", 0x04034B50, _ZIP_VERSION, 0, 0, _ZIP_TIME,
                _ZIP_DATE, crc.result(), _ZIP_MAX32, _ZIP_MAX32, len(name),
                20) + name + struct.pack("<HHQQ", 1, 16, size, size))
            f.write(head)
            if body is not None:
                for at in range(0, body.size, _WRITE_SLICE):
                    f.write(body[at:at + _WRITE_SLICE].data)
            central.append((name, crc.result(), size, offset))
        cd_offset = f.tell()
        for name, crc, size, offset in central:
            f.write(struct.pack(
                "<IHHHHHHIIIHHHHHII", 0x02014B50, _ZIP_VERSION,
                _ZIP_VERSION, 0, 0, _ZIP_TIME, _ZIP_DATE, crc, _ZIP_MAX32,
                _ZIP_MAX32, len(name), 28, 0, 0, 0, 0, _ZIP_MAX32) + name
                + struct.pack("<HHQQQ", 1, 24, size, size, offset))
        end64 = f.tell()
        n, cd_size = len(central), end64 - cd_offset
        f.write(struct.pack("<IQHHIIQQQQ", 0x06064B50, 44, _ZIP_VERSION,
                            _ZIP_VERSION, 0, 0, n, n, cd_size, cd_offset))
        f.write(struct.pack("<IIQI", 0x07064B50, 0, end64, 1))
        f.write(struct.pack("<IHHHHIIH", 0x06054B50, 0, 0,
                            min(n, _ZIP_MAX16), min(n, _ZIP_MAX16),
                            min(cd_size, _ZIP_MAX32),
                            min(cd_offset, _ZIP_MAX32), 0))


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
        self._seal()
        self._publish()

    def _seal(self, progress_cb=None):
        """Durability: the manifest and the fsync of every payload file and
        of the temp dir, the part that grows with the payload (the only
        part an async commit moves off the training thread).
        ``progress_cb()`` runs after each file."""
        self.meta.setdefault("tag", self.tag)
        chaos.point("before_manifest")
        write_manifest(self.tmp, self.meta, fsync=self.fsync)
        if progress_cb is not None:
            progress_cb()
        if self.fsync:
            for rel in _walk_payload(self.tmp):
                _fsync_path(os.path.join(self.tmp, rel))
                if progress_cb is not None:
                    progress_cb()
            _fsync_path(self.tmp)

    def _publish(self):
        """Visibility: the atomic rename, then the ``latest`` pointer; O(1)
        in the payload's size."""
        chaos.point("before_rename")
        if os.path.isdir(self.final):
            # an overwritten tag takes two renames; the old copy is parked
            # under a name the resume scan still takes for a tag, so a
            # crash between them never leaves no copy of this tag
            doomed = os.path.join(self.save_dir, f"{self.tag}.replaced")
            if os.path.isdir(doomed):
                shutil.rmtree(doomed)
            os.replace(self.final, doomed)
            try:
                chaos.point("between_swap")
                os.replace(self.tmp, self.final)
            except BaseException:
                os.replace(doomed, self.final)
                raise
            shutil.rmtree(doomed, ignore_errors=True)
        else:
            os.replace(self.tmp, self.final)
        if self.fsync:
            _fsync_path(self.save_dir)
        chaos.point("before_latest")
        if self.update_latest:
            write_latest(self.save_dir, self.tag, fsync=self.fsync)


class PendingCommit:
    """One asynchronous commit in flight. A thread (``start``) sets up the
    temp dir, runs ``write_fn(tmp)`` (the payload writer over a host
    snapshot already taken) and seals the tag; ``finalize``, on the
    training thread once ``ready()``, publishes it. Until then only a
    ``.tmp-`` dir exists, so a kill at any point leaves the previous
    checkpoint as it was. A failure on the thread (a chaos kill
    included) removes the temp dir and is raised again by ``finalize``.
    ``heartbeat()`` runs after each written file, so a slow disk feeds
    the watchdog as progress."""

    def __init__(self, commit, write_fn, heartbeat=None):
        assert isinstance(commit, atomic_tag)
        self.commit = commit
        self.write_fn = write_fn
        self.heartbeat = heartbeat
        self.error = None
        self.finalized = False
        self._done = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"ckpt-commit-{commit.tag}", daemon=True)

    def start(self):
        self._thread.start()
        return self

    def _beat(self):
        if self.heartbeat is not None:
            self.heartbeat()

    def _run(self):
        try:
            self._beat()
            self.commit.__enter__()
            self.write_fn(self.commit.tmp)
            self._beat()
            self.commit._seal(progress_cb=self._beat)
            self._beat()
        except BaseException as e:  # noqa: B036 - raised by finalize()
            self.error = e
            shutil.rmtree(self.commit.tmp, ignore_errors=True)
        finally:
            self._done.set()

    def ready(self):
        """True once the thread's work has finished, well or badly."""
        return self._done.is_set()

    def wait(self, timeout=None):
        return self._done.wait(timeout)

    def finalize(self):
        """Publish the sealed tag on the calling thread, waiting for the
        seal first; raises the thread's error (each call again) or the
        publish's, so save_dir holds the previous checkpoint intact or
        the new tag whole."""
        self._done.wait()
        if self.finalized:
            return
        if self.error is not None:
            raise self.error
        try:
            self.commit._publish()
        except BaseException:
            shutil.rmtree(self.commit.tmp, ignore_errors=True)
            raise
        finally:
            self.finalized = True


class FollowerCommit:
    """The pending commit of a rank that writes no payload: every rank runs
    the same finalize steps."""

    error = None
    finalized = False

    def start(self):
        return self

    def ready(self):
        return True

    def wait(self, timeout=None):
        return True

    def finalize(self):
        self.finalized = True


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


def looks_like_tag(tag_dir):
    """True for a directory that is plausibly a checkpoint tag (a manifest,
    possibly corrupt, or a ``metadata.pkl``), so that retention and the
    resume scan leave other directories alone."""
    return (os.path.exists(os.path.join(tag_dir, MANIFEST_NAME))
            or os.path.isfile(os.path.join(tag_dir, "metadata.pkl")))


def _list_tag_entries(save_dir):
    """[(tag, manifest or None)], newest first (manifest step, then mtime,
    then name), one manifest parse per tag."""
    if not os.path.isdir(save_dir):
        return []
    entries = []
    for name in os.listdir(save_dir):
        if name.startswith(TMP_PREFIX):
            continue
        tag_dir = os.path.join(save_dir, name)
        if not os.path.isdir(tag_dir) or not looks_like_tag(tag_dir):
            continue
        manifest = load_manifest(tag_dir)
        step = manifest.get("global_steps", -1) if manifest else -1
        entries.append((step, os.path.getmtime(tag_dir), name, manifest))
    entries.sort(key=lambda e: e[:3], reverse=True)
    return [(name, manifest) for _s, _m, name, manifest in entries]


def list_tags(save_dir):
    """Committed tag names, newest first (manifest step, then mtime)."""
    return [name for name, _manifest in _list_tag_entries(save_dir)]


def _emergency_from_manifest(tag, manifest):
    if manifest is not None and "emergency" in manifest:
        return bool(manifest["emergency"])
    return str(tag).startswith("emergency_")


def _suspect_from_manifest(tag, manifest):
    """True for a tag whose manifest says ``integrity_clean: false``:
    committed inside an open integrity anomaly window, its bytes verify
    but its numbers are suspect."""
    return manifest is not None and manifest.get("integrity_clean") is False


def _resume_rank(tag, manifest):
    """The resume order's class: healthy tags, then suspect tags, then the
    watchdog's emergency tags."""
    if _emergency_from_manifest(tag, manifest):
        return 2
    if _suspect_from_manifest(tag, manifest):
        return 1
    return 0


def read_topology(tag_dir):
    """The tag's topology manifest (resilience/reshard.py), read without
    unpickling any payload; None for a tag without one."""
    manifest = load_manifest(tag_dir)
    if manifest is None:
        return None
    return manifest.get("topology")


def is_preempt_tag(save_dir, tag):
    """True for a graceful-preemption tag (manifest ``preempt``): healthy
    state, resumed first like any other tag."""
    manifest = load_manifest(os.path.join(save_dir, str(tag)))
    return bool(manifest.get("preempt")) if manifest else False


def is_suspect_tag(save_dir, tag):
    """True for a tag committed inside an open integrity anomaly window."""
    return _suspect_from_manifest(
        tag, load_manifest(os.path.join(save_dir, str(tag))))


def is_emergency_tag(save_dir, tag):
    """True for the watchdog's pre-abort tags: the manifest's ``emergency``
    flag, else the ``emergency_`` name."""
    return _emergency_from_manifest(
        tag, load_manifest(os.path.join(save_dir, str(tag))))


def resume_candidates(save_dir):
    """Every committed tag, newest first, healthy before suspect before
    emergency; the ``latest`` tag is added if the scan missed it."""
    entries = _list_tag_entries(save_dir)
    latest = read_latest(save_dir)
    if latest is not None and latest not in [n for n, _m in entries]:
        entries.append((latest,
                        load_manifest(os.path.join(save_dir, latest))))
    return [name for name, _manifest in
            sorted(entries, key=lambda e: _resume_rank(*e))]


def select_resume_tag(save_dir, check_checksums=True):
    """The first of ``resume_candidates`` that verifies, or None."""
    for tag in resume_candidates(save_dir):
        ok, reason = verify_tag(os.path.join(save_dir, tag),
                                check_checksums=check_checksums)
        if ok:
            return tag
        logger.warning(f"auto-resume: skipping checkpoint tag {tag!r} "
                       f"({reason})")
    return None


def gc_tags(save_dir, keep, protect=()):
    """Retention: remove stale ``.tmp-`` entries always; keep the newest
    ``keep`` tags that pass a size check (0 keeps all). The ``latest``
    tag and ``protect`` stay; a tag failing the check takes no slot and
    goes; emergency tags take no slot and stay. Returns what went."""
    if not os.path.isdir(save_dir):
        return []
    removed = []
    for name in os.listdir(save_dir):
        if name.startswith(TMP_PREFIX):
            full = os.path.join(save_dir, name)
            if os.path.isdir(full):
                shutil.rmtree(full, ignore_errors=True)
            else:
                try:
                    os.remove(full)
                except OSError:
                    continue
            removed.append(name)
    if not keep or keep <= 0:
        return removed
    keepers = set(protect)
    latest = read_latest(save_dir)
    if latest:
        keepers.add(latest)
    for tag, manifest in _list_tag_entries(save_dir):
        if tag in keepers:
            continue
        full = os.path.join(save_dir, tag)
        if _emergency_from_manifest(tag, manifest):
            continue
        if len(keepers) < keep:
            ok, reason = verify_tag(full, check_checksums=False)
            if ok:
                keepers.add(tag)
                continue
            logger.warning(f"checkpoint GC: tag {tag!r} fails verification "
                           f"({reason}); not counted toward retention")
        shutil.rmtree(full, ignore_errors=True)
        removed.append(tag)
        logger.info(f"checkpoint GC: removed old tag {tag!r}")
    return removed
