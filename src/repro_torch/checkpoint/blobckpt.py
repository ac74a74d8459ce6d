"""Versioned, incremental, branchable checkpoints over BlobSeer.

The port of ``repro.checkpoint.blobckpt``, writing the same blob layout
so that either package restores what the other saved:

* the training state (nested dicts and lists of tensors) is laid out in
  one blob, each leaf at a page-aligned offset after the header region,
  leaves in the order of their sorted ``"/"``-joined keys;
* each save writes only the changed page runs, found by the
  ``page_digest`` and ``delta_mask`` kernels on the leaf's own device:
  only the pages that are written are copied to the host.  All dirty
  runs of one save go through one ``BlobClient.write_many`` with their
  page digests passed through as the dedup-handshake input;
* commit protocol: data pages -> manifest (``format: 1``: layout, step,
  hex digests, ``extra`` such as the reader cursor) -> a one-page commit
  pointer naming the manifest write's snapshot version; the rolling GC
  pin on that snapshot is taken before the commit write;
* ``branch`` forks the lineage in O(1) bytes.

A bf16 leaf is stored as its raw 16-bit words under the dtype string
``"bfloat16"``, as the reference stores its ml_dtypes arrays.

Under a mesh (DTensor leaves) every rank calls ``save``: each leaf is
gathered whole, one leaf at a time (a collective every rank joins, as the
reference's per-leaf ``device_get``), and rank 0 alone digests and writes
it; the other ranks return None.  ``restore`` returns whole tensors,
which the caller places (``TrainStepBuilder.distribute_state``).
"""

from __future__ import annotations

import json
import warnings
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.blob import BlobClient
from repro_torch.distributed.partitioning import full, is_distributed
from repro_torch.core.version_manager import RetiredVersion, VersionUnpublished
from repro_torch.kernels import ops


@dataclass
class CheckpointStats:
    version: int
    step: int
    total_bytes: int
    written_bytes: int
    pages_total: int
    pages_written: int

    @property
    def sharing_fraction(self) -> float:
        return 1.0 - (self.pages_written / max(self.pages_total, 1))


def _paths(tree, prefix: Tuple[str, ...] = ()):
    """(key path, leaf) of every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield prefix, tree


def flatten_with_paths(tree) -> List[Tuple[str, torch.Tensor]]:
    """Leaves keyed by their ``"/"``-joined dict keys and list indices,
    sorted by key (the reference's ``_flatten_with_paths``)."""
    return sorted((("/".join(p), leaf) for p, leaf in _paths(tree)), key=lambda kv: kv[0])


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy name the reference writes: ``"float32"``, ``"bfloat16"``."""
    return str(dtype).removeprefix("torch.")


def tensor_from_bytes(raw: bytes, dtype: str, shape, device) -> torch.Tensor:
    """A leaf rebuilt from its stored bytes, on ``device``."""
    with warnings.catch_warnings():
        # torch warns that the bytes are read-only; they are copied below
        warnings.simplefilter("ignore", UserWarning)
        flat = torch.frombuffer(raw, dtype=torch.uint8)
    return flat.to(device, copy=True).view(getattr(torch, dtype)).reshape(shape)


class BlobCheckpointer:
    def __init__(
        self,
        client: BlobClient,
        blob_id: Optional[str] = None,
        *,
        psize: int = 256 * 1024,
        header_pages: int = 64,
    ) -> None:
        self.client = client
        if blob_id is None:
            blob_id = client.create(psize=psize)
        self.blob_id = blob_id
        self.psize = client.vm.psize_of(blob_id)
        self.header_bytes = header_pages * self.psize
        # header layout: [commit pointer page][manifest region]
        self.manifest_off = self.psize
        self._digests: Dict[str, np.ndarray] = {}   # path -> (n_pages, 2) u32
        self._layout: Dict[str, Tuple[int, int]] = {}  # path -> (offset, nbytes)
        # rolling GC pin on the latest commit's manifest snapshot
        self._manifest_lease: Optional[str] = None

    # ------------------------------------------------------------------- save
    def save(self, state, step: int, extra: Optional[Dict] = None) -> Optional[CheckpointStats]:
        """Write an incremental checkpoint; returns sharing stats (None on
        a rank other than 0 under a mesh)."""
        leaves = flatten_with_paths(state)
        if any(is_distributed(leaf) for _, leaf in leaves):
            import torch.distributed as dist

            if dist.get_rank() != 0:
                for _, leaf in leaves:
                    full(leaf)          # join each leaf's gather, in rank 0's order
                return None
        psz = self.psize

        # -- layout: leaf offsets page-aligned after the header region --
        offset = self.header_bytes
        layout: Dict[str, Tuple[int, int]] = {}
        for path, leaf in leaves:
            nbytes = max(leaf.numel() * leaf.element_size(), 1)
            layout[path] = (offset, nbytes)
            offset += -(-nbytes // psz) * psz
        total = offset
        layout_changed = layout != self._layout

        # BlobSeer WRITE forbids holes: on first save, commit a zero
        # header so the page-aligned leaf writes extend the blob
        # contiguously.
        recent = self.client.get_recent(self.blob_id)
        cur_size = self.client.get_size(self.blob_id, recent) if recent else 0
        if cur_size < self.header_bytes:
            self.client.write(self.blob_id, b"\0" * self.header_bytes, 0)

        written_bytes = 0
        pages_written = 0
        pages_total = (total - self.header_bytes) // psz
        manifest_leaves = []
        new_digests: Dict[str, np.ndarray] = {}
        # dirty page runs of all leaves, written as one write_many batch,
        # each with its pages' digests for the dedup handshake
        dirty_writes: List[Tuple[bytes, int]] = []
        dirty_digests: List[List[Tuple[int, int]]] = []
        for path, leaf in leaves:
            off, nbytes = layout[path]
            data = ops.leaf_bytes(full(leaf))                 # the whole leaf, gathered
            dg = ops.page_digest(data, page_bytes=psz)        # on the leaf's device
            dg_host = dg.cpu().numpy().view(np.uint32)
            new_digests[path] = dg_host
            old = self._digests.get(path)
            if layout_changed or old is None or old.shape != dg_host.shape:
                dirty = np.ones(dg_host.shape[0], dtype=bool)
            else:
                old_dev = torch.tensor(old.view(np.int32), device=dg.device)
                dirty = ops.delta_mask(dg, old_dev).cpu().numpy()
            # contiguous dirty page runs, zero-padded to full pages
            n_pages = dg_host.shape[0]
            i = 0
            while i < n_pages:
                if not dirty[i]:
                    i += 1
                    continue
                j = i
                while j < n_pages and dirty[j]:
                    j += 1
                lo = i * psz
                chunk = data[lo:j * psz].cpu().numpy().tobytes()
                pad = (j - i) * psz - len(chunk)
                if pad:
                    chunk = chunk + b"\0" * pad
                dirty_writes.append((chunk, off + lo))
                dirty_digests.append(
                    [(int(dg_host[k, 0]), int(dg_host[k, 1])) for k in range(i, j)])
                written_bytes += len(chunk)
                pages_written += j - i
                i = j
            manifest_leaves.append({
                "path": path,
                "shape": list(leaf.shape),
                "dtype": dtype_name(leaf.dtype),
                "offset": off,
                "nbytes": nbytes,
            })

        if dirty_writes:
            self.client.write_many(self.blob_id, dirty_writes, digests=dirty_digests)
        del dirty_writes

        manifest = {
            "format": 1,
            "step": step,
            "total_bytes": total,
            "leaves": manifest_leaves,
            "extra": extra or {},
            "digests": {p: d.tobytes().hex() for p, d in new_digests.items()},
        }
        payload = zlib.compress(json.dumps(manifest).encode())
        record = len(payload).to_bytes(8, "little") + payload
        if len(record) > self.header_bytes - self.manifest_off:
            raise ValueError(
                f"manifest ({len(record)}B) exceeds header region "
                f"({self.header_bytes - self.manifest_off}B); raise header_pages"
            )
        # commit protocol: manifest, then the commit pointer naming the
        # manifest write's snapshot version (restores read AT that version)
        vm_version = self.client.write(self.blob_id, record, self.manifest_off)
        self.client.sync(self.blob_id, vm_version)
        # roll the GC pin forward while the manifest snapshot is still the
        # newest published version: pinning after the commit write would
        # leave a window where a retention GC round retires it
        lease = self.client.pin(self.blob_id, vm_version)
        try:
            commit = vm_version.to_bytes(8, "little") + b"\1"
            vc = self.client.write(self.blob_id, commit, 0)
            self.client.sync(self.blob_id, vc)
        except BaseException:
            # failed commit: release the fresh pin, or it excludes this
            # snapshot from GC forever
            try:
                self.client.unpin(lease)
            except Exception:
                pass  # best effort (e.g. wire down); save() still fails
            raise
        if self._manifest_lease is not None:
            self.client.unpin(self._manifest_lease)
        self._manifest_lease = lease
        self._digests = new_digests
        self._layout = layout
        written_bytes += len(record) + len(commit)
        return CheckpointStats(
            version=vc, step=step, total_bytes=total,
            written_bytes=written_bytes, pages_total=pages_total,
            pages_written=pages_written,
        )

    # ---------------------------------------------------------------- restore
    def read_manifest(self, version: Optional[int] = None) -> Tuple[Dict, int]:
        """(manifest, resolved_version). Leaf reads must use the latter."""
        at = version if version is not None else self.client.get_recent(self.blob_id)
        if at == 0:
            raise FileNotFoundError("no checkpoint published yet")
        head = self.client.read(self.blob_id, at, 0, 9)
        if head[8] != 1:
            raise FileNotFoundError("no checkpoint committed yet")
        vm = int.from_bytes(head[:8], "little")
        head = self.client.read(self.blob_id, vm, self.manifest_off, 8)
        n = int.from_bytes(head, "little")
        raw = self.client.read(self.blob_id, vm, self.manifest_off + 8, n)
        manifest = json.loads(zlib.decompress(raw))
        return manifest, vm

    def restore(self, like, version: Optional[int] = None,
                with_manifest: bool = False, device="cuda"):
        """Rebuild a state tree shaped ``like`` from a checkpoint.

        ``like`` gives only the structure (its leaves may be meta
        tensors); restored leaves are new tensors on ``device`` with the
        stored dtype and shape.  The commit-pointer snapshot and the
        manifest snapshot are pinned before their reads, so a concurrent
        GC round cannot sweep the checkpoint mid-read; if GC retired the
        snapshot first, the pin raises ``RetiredVersion``.
        """
        at = version if version is not None else self.client.get_recent(self.blob_id)
        outer = self.client.pin(self.blob_id, at) if at > 0 else None
        try:
            manifest, version = self.read_manifest(at)
            lease = self.client.pin(self.blob_id, version)
        finally:
            if outer is not None:
                self.client.unpin(outer)
        try:
            by_path = {l["path"]: l for l in manifest["leaves"]}

            def load(path: Tuple[str, ...]) -> torch.Tensor:
                key = "/".join(path)
                rec = by_path.get(key)
                if rec is None:
                    raise KeyError(f"checkpoint v{version} missing leaf {key}")
                raw = self.client.read(self.blob_id, version, rec["offset"], rec["nbytes"])
                return tensor_from_bytes(raw, rec["dtype"], rec["shape"], device)

            def rebuild(node, path: Tuple[str, ...]):
                if isinstance(node, dict):
                    return {k: rebuild(v, path + (str(k),)) for k, v in node.items()}
                if isinstance(node, (list, tuple)):
                    return [rebuild(v, path + (str(i),)) for i, v in enumerate(node)]
                return load(path)

            tree = rebuild(like, ())
        finally:
            self.client.unpin(lease)
        if with_manifest:
            return tree, manifest
        return tree

    def load_digest_cache(self, version: Optional[int] = None) -> None:
        """Resume delta detection after a trainer restart."""
        manifest, _ = self.read_manifest(version)
        self._digests = {
            p: np.frombuffer(bytes.fromhex(h), dtype=np.uint32).reshape(-1, 2)
            for p, h in manifest.get("digests", {}).items()
        }
        self._layout = {
            l["path"]: (l["offset"], l["nbytes"]) for l in manifest["leaves"]
        }

    # ----------------------------------------------------------------- branch
    def branch(self, version: Optional[int] = None) -> "BlobCheckpointer":
        """Fork the lineage at a commit version (default: most recent)."""
        if version is None:
            version = self.client.get_recent(self.blob_id)
        bid = self.client.branch(self.blob_id, version)
        child = BlobCheckpointer(self.client, bid,
                                 header_pages=self.header_bytes // self.psize)
        child.load_digest_cache(version)
        return child

    def steps(self) -> List[Tuple[int, int]]:
        """(version, step) of every complete checkpoint in the lineage."""
        out = []
        recent = self.client.get_recent(self.blob_id)
        seen = set()
        v = recent
        while v > 0:
            try:
                manifest, _ = self.read_manifest(v)
            except (FileNotFoundError, VersionUnpublished, RetiredVersion):
                # typed end of history only: nothing committed at v, a
                # never-assigned version, or one GC already retired; any
                # other error propagates rather than truncating the list
                break
            key = manifest["step"]
            if key not in seen:
                out.append((v, key))
                seen.add(key)
            # jump to before this checkpoint's writes: heuristic walk
            v -= 1
            if len(out) > 10_000:
                break
        return sorted(out)
