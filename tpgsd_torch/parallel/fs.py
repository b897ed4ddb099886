"""Shared-filesystem detection for the direct multi-process write path.

The direct path's contract is N processes issuing ``pwrite`` at
DISJOINT offsets into one shared file (the role of the reference's
``MPI_File_write_at``, reference: pgsd/pgsd/pgsd.c:2225-2237).  Whether
that is safe depends on the filesystem's concurrent-writer semantics -
the deployment concern the reference delegates wholesale to MPI-IO and
its Lustre-aware I/O stack (reference: pgsd/pgsd/pgsd.h:449,
pgsd/INSTALLING.rst:127-135).  tpgsd makes the policy explicit:

* **local POSIX** (ext4/xfs/btrfs/tmpfs/zfs/overlay): disjoint-offset
  concurrent pwrites are coherent through the shared page cache - the
  direct path is fully supported (and is what the multi-process suite
  validates).
* **parallel cluster filesystems** (Lustre, GPFS/Spectrum Scale,
  BeeGFS, CephFS, PanFS): designed for exactly this access pattern
  (MPI-IO's home turf) - direct path supported.
* **NFS/SMB**: close-to-open consistency only; two CLIENTS writing one
  file concurrently may cache and flush inconsistently, and O_DIRECT
  behavior is server-dependent.  Multi-process on ONE host shares the
  client page cache and is coherent; spanning hosts is not guaranteed -
  use :class:`tpgsd.parallel.ComposedFrameWriter`.
* **object-store mounts** (gcsfuse, s3fs, blobfuse): no concurrent
  writers of one object at all - use ``ComposedFrameWriter``.

The normative statement lives in ``docs/parallel.md`` ("Shared-
filesystem semantics"); this module is the runtime detection behind
the advisory warning the file layer emits when a multi-process handle
opens a file on a filesystem in the last two classes.
"""

import os
import warnings

# fstype -> class.  Sources: /proc/mounts fstype strings (Linux).
_LOCAL = {
    "ext2", "ext3", "ext4", "xfs", "btrfs", "zfs", "f2fs", "reiserfs",
    "tmpfs", "ramfs", "overlay", "overlayfs", "squashfs", "vfat", "exfat",
    "apfs", "hfs", "hfsplus", "ufs",
}
_PARALLEL = {"lustre", "gpfs", "beegfs", "ceph", "cephfs", "panfs", "pvfs2",
             "orangefs", "fhgfs"}
_NETWORK = {"nfs", "nfs4", "cifs", "smb", "smbfs", "smb2", "afs", "9p",
            "sshfs", "glusterfs"}


def filesystem_kind(path, mounts=None):
    """Classify the filesystem holding ``path``.

    Returns one of ``"local"``, ``"parallel"``, ``"network"``,
    ``"objectstore"``, ``"unknown"``.  ``mounts`` overrides the mount
    table for tests: an iterable of ``(mount_point, fstype)`` pairs;
    by default ``/proc/mounts`` is parsed.  Longest-prefix mount point
    wins (standard mount shadowing).
    """
    target = os.path.realpath(os.path.abspath(str(path)))
    if mounts is None:
        mounts = _read_proc_mounts()
    best_len, best_type = -1, None
    for point, fstype in mounts:
        point = point.rstrip("/") or "/"
        if target == point or target.startswith(
            point if point == "/" else point + "/"
        ):
            # >= so the LAST equal-point entry wins: /proc/mounts lists
            # mounts in order, and an overmount on the same point
            # shadows every earlier entry
            if len(point) >= best_len:
                best_len, best_type = len(point), fstype
    if best_type is None:
        return "unknown"
    t = best_type.lower()
    if t.startswith("fuse"):
        # fuse.gcsfuse / fuse.s3fs / fuse.blobfuse / plain "fuse":
        # assume object-store semantics (sequential-writer only) -
        # the conservative read of an unknown FUSE filesystem
        sub = t.split(".", 1)[1] if "." in t else ""
        if sub in ("sshfs", "glusterfs"):
            return "network"
        return "objectstore"
    if t in _LOCAL:
        return "local"
    if t in _PARALLEL:
        return "parallel"
    if t in _NETWORK:
        return "network"
    return "unknown"


def _read_proc_mounts():
    try:
        with open("/proc/mounts", "r") as f:
            out = []
            for line in f:
                parts = line.split()
                if len(parts) >= 3:
                    # octal-escaped spaces in mount points (\040)
                    point = parts[1].replace("\\040", " ")
                    out.append((point, parts[2]))
            return out
    except OSError:
        return []


def direct_write_policy(path, n_processes, mounts=None):
    """Policy for ``n_processes`` direct-writing one shared file.

    Returns ``(policy, reason)`` with policy one of:

    * ``"direct"`` - disjoint-offset concurrent pwrites are safe here.
    * ``"direct-warn"`` - proceed, but semantics are not guaranteed
      across hosts; the reason names the alternative.
    * ``"compose"`` - the filesystem cannot support concurrent writers
      of one file; use ``ComposedFrameWriter``.
    """
    if n_processes <= 1:
        return "direct", "single process: plain positioned writes"
    if mounts is None and not _read_proc_mounts():
        # no mount table on this platform (e.g. no /proc/mounts):
        # nothing to classify against - don't cry wolf on every open;
        # the normative docs chapter covers when to choose compose
        return "direct", (
            "no mount table available on this platform: filesystem "
            "class unknown, proceeding with POSIX positioned writes"
        )
    kind = filesystem_kind(path, mounts=mounts)
    if kind in ("local", "parallel"):
        return "direct", "%s filesystem: concurrent disjoint-offset " \
            "writers are coherent" % kind
    if kind == "objectstore":
        return "compose", (
            "object-store mount: no concurrent writers of one object - "
            "use tpgsd.parallel.ComposedFrameWriter (per-process spill "
            "files composed at close)"
        )
    if kind == "network":
        return "direct-warn", (
            "network filesystem (close-to-open consistency): concurrent "
            "writers are coherent only within one host's page cache; "
            "across hosts use tpgsd.parallel.ComposedFrameWriter"
        )
    return "direct-warn", (
        "unknown filesystem: assuming POSIX concurrent-writer "
        "semantics; if writes interleave incorrectly use "
        "tpgsd.parallel.ComposedFrameWriter"
    )


def warn_if_risky(path, n_processes, mounts=None):
    """Emit one advisory ``RuntimeWarning`` when a multi-process direct
    writer opens on a filesystem without guaranteed concurrent-writer
    semantics.  Returns the policy string."""
    policy, reason = direct_write_policy(path, n_processes, mounts=mounts)
    if policy != "direct":
        warnings.warn(
            "multi-process write of %r: %s" % (str(path), reason),
            RuntimeWarning,
            stacklevel=3,
        )
    return policy
