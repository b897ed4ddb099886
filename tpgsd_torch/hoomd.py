"""HOOMD schema layer: read and write ``hoomd`` schema GSD files.

* :func:`open` - open a hoomd schema file.
* :class:`HOOMDTrajectory` - read and write trajectories.
* :class:`Frame` - the state of a single frame (``Snapshot`` is an alias).
* :func:`read_log` - read ``log/*`` quantities into time-series arrays.

Superset of the reference schema layer (reference: pgsd/pgsd/hoomd.py):

* carries the reference's SPH extension fields (``slength``, ``density``,
  ``pressure``, ``energy``, ``auxiliary1-4``;
  reference: pgsd/pgsd/hoomd.py:175-182) *and* the full upstream HOOMD
  field set (orientation, charge, diameter, moment_inertia, angmom).
* wires bond topology (bonds/angles/dihedrals/impropers/pairs) into
  :class:`Frame` - the reference keeps :class:`BondData` but never attaches
  it (reference: pgsd/pgsd/hoomd.py:450-453).
* ``append()`` actually works - the reference raises NotImplementedError
  (reference: pgsd/pgsd/hoomd.py:568); the distributed semantics follow the
  reference's commented-out intended design (reference:
  pgsd/pgsd/hoomd.py:574-642): per-particle chunks carry the per-shard
  row-count vector ``frame.part_dist``, scalar chunks are controller-only.

Numpy only: torch tensors are handled by ``tpgsd_torch.parallel`` which
converts them to host arrays before reaching this layer.  This is the
port's copy of ``tpgsd/hoomd.py``; both packages read each other's files.
"""

import json
import logging
import warnings
from collections import OrderedDict

import numpy

from . import fl
from .version import version

logger = logging.getLogger("tpgsd_torch.hoomd")


class ConfigurationData:
    """Store configuration data.

    Attributes:
        step (int): time step of this frame (:chunk:`configuration/step`).
        dimensions (int): number of dimensions. Defaults from the box: 2
            when Lz == 0, else 3; user-set values take precedence
            (reference: pgsd/pgsd/hoomd.py:45-108).
    """

    _default_value = OrderedDict()
    _default_value["step"] = numpy.uint64(0)
    _default_value["dimensions"] = numpy.uint8(3)
    _default_value["box"] = numpy.array([1, 1, 1, 0, 0, 0], dtype=numpy.float32)

    def __init__(self):
        self.step = None
        self.dimensions = None
        self._box = None

    @property
    def box(self):
        """(6,) float32: box dimensions [lx, ly, lz, xy, xz, yz]."""
        return self._box

    @box.setter
    def box(self, box):
        self._box = box
        try:
            Lz = box[2]
        except TypeError:
            return
        else:
            if self.dimensions is None:
                self.dimensions = 2 if Lz == 0 else 3

    def validate(self):
        """Normalize attributes to contiguous arrays of the proper type."""
        logger.debug("Validating ConfigurationData")
        if self.box is not None:
            self._box = numpy.ascontiguousarray(self.box, dtype=numpy.float32)
            self._box = self._box.reshape([6])


class ParticleData:
    """Store per-particle data chunks.

    Includes the HOOMD standard fields and the SPH extension fields
    (``slength``, ``density``, ``pressure``, ``energy``, ``auxiliary1-4``)
    the reference adds for smoothed-particle-hydrodynamics output
    (reference: pgsd/pgsd/hoomd.py:167-203).
    """

    _default_value = OrderedDict()
    _default_value["N"] = numpy.uint32(0)
    _default_value["types"] = ["A"]
    _default_value["typeid"] = numpy.uint32(0)
    _default_value["mass"] = numpy.float32(1.0)
    _default_value["charge"] = numpy.float32(0.0)
    _default_value["diameter"] = numpy.float32(1.0)
    _default_value["body"] = numpy.int32(-1)
    _default_value["moment_inertia"] = numpy.array([0, 0, 0], dtype=numpy.float32)
    _default_value["position"] = numpy.array([0, 0, 0], dtype=numpy.float32)
    _default_value["orientation"] = numpy.array([1, 0, 0, 0], dtype=numpy.float32)
    _default_value["velocity"] = numpy.array([0, 0, 0], dtype=numpy.float32)
    _default_value["angmom"] = numpy.array([0, 0, 0, 0], dtype=numpy.float32)
    # SPH extension fields (reference: pgsd/pgsd/hoomd.py:175-182)
    _default_value["slength"] = numpy.float32(1.0)
    _default_value["density"] = numpy.float32(0.0)
    _default_value["pressure"] = numpy.float32(0.0)
    _default_value["energy"] = numpy.float32(0.0)
    _default_value["auxiliary1"] = numpy.array([0, 0, 0], dtype=numpy.float32)
    _default_value["auxiliary2"] = numpy.array([0, 0, 0], dtype=numpy.float32)
    _default_value["auxiliary3"] = numpy.array([0, 0, 0], dtype=numpy.float32)
    _default_value["auxiliary4"] = numpy.array([0, 0, 0], dtype=numpy.float32)
    _default_value["image"] = numpy.array([0, 0, 0], dtype=numpy.int32)
    _default_value["type_shapes"] = [{}]

    # (field, per-row shape, dtype) for validation
    _shapes = {
        "typeid": ((), numpy.uint32),
        "mass": ((), numpy.float32),
        "charge": ((), numpy.float32),
        "diameter": ((), numpy.float32),
        "body": ((), numpy.int32),
        "moment_inertia": ((3,), numpy.float32),
        "position": ((3,), numpy.float32),
        "orientation": ((4,), numpy.float32),
        "velocity": ((3,), numpy.float32),
        "angmom": ((4,), numpy.float32),
        "slength": ((), numpy.float32),
        "density": ((), numpy.float32),
        "pressure": ((), numpy.float32),
        "energy": ((), numpy.float32),
        "auxiliary1": ((3,), numpy.float32),
        "auxiliary2": ((3,), numpy.float32),
        "auxiliary3": ((3,), numpy.float32),
        "auxiliary4": ((3,), numpy.float32),
        "image": ((3,), numpy.int32),
    }

    def __init__(self):
        self.N = 0
        self.types = None
        self.type_shapes = None
        for name in self._shapes:
            setattr(self, name, None)

    def validate(self):
        """Normalize attributes to contiguous arrays of the proper type
        and shape; ignore ``None`` attributes.
        """
        logger.debug("Validating ParticleData")
        for name, (row_shape, dtype) in self._shapes.items():
            value = getattr(self, name)
            if value is not None:
                value = numpy.ascontiguousarray(value, dtype=dtype)
                value = value.reshape([int(self.N)] + list(row_shape))
                setattr(self, name, value)
        if self.types is not None and len(set(self.types)) != len(self.types):
            raise ValueError("Type names must be unique.")


class BondData:
    """Store bond/angle/dihedral/improper/pair topology chunks.

    ``M`` is the number of particles per connection: bond 2, angle 3,
    dihedral 4, improper 4, pair 2 (reference: pgsd/pgsd/hoomd.py:273-362).
    """

    def __init__(self, M):
        self.M = M
        self.N = 0
        self.types = None
        self.typeid = None
        self.group = None

        self._default_value = OrderedDict()
        self._default_value["N"] = numpy.uint32(0)
        self._default_value["types"] = []
        self._default_value["typeid"] = numpy.uint32(0)
        self._default_value["group"] = numpy.array([0] * M, dtype=numpy.int32)

    def validate(self):
        """Normalize attributes; ignore ``None``; reject duplicate types."""
        logger.debug("Validating BondData")
        if self.typeid is not None:
            self.typeid = numpy.ascontiguousarray(self.typeid, dtype=numpy.uint32)
            self.typeid = self.typeid.reshape([int(self.N)])
        if self.group is not None:
            self.group = numpy.ascontiguousarray(self.group, dtype=numpy.int32)
            self.group = self.group.reshape([int(self.N), self.M])
        if self.types is not None and len(set(self.types)) != len(self.types):
            raise ValueError("Type names must be unique.")


class ConstraintData:
    """Store distance-constraint data (reference: pgsd/pgsd/hoomd.py:365-421)."""

    def __init__(self):
        self.M = 2
        self.N = 0
        self.value = None
        self.group = None

        self._default_value = OrderedDict()
        self._default_value["N"] = numpy.uint32(0)
        self._default_value["value"] = numpy.float32(0)
        self._default_value["group"] = numpy.array([0] * self.M, dtype=numpy.int32)

    def validate(self):
        """Normalize attributes; ignore ``None``."""
        logger.debug("Validating ConstraintData")
        if self.value is not None:
            self.value = numpy.ascontiguousarray(self.value, dtype=numpy.float32)
            self.value = self.value.reshape([int(self.N)])
        if self.group is not None:
            self.group = numpy.ascontiguousarray(self.group, dtype=numpy.int32)
            self.group = self.group.reshape([int(self.N), self.M])


#: container attribute -> chunk path prefix, in write order
_CONTAINERS = [
    "configuration",
    "particles",
    "bonds",
    "angles",
    "dihedrals",
    "impropers",
    "constraints",
    "pairs",
]


class Frame:
    """System state at one point in time.

    Attributes:
        configuration (ConfigurationData)
        particles (ParticleData)
        bonds, angles, dihedrals, impropers, pairs (BondData)
        constraints (ConstraintData)
        state (dict): state chunks (``state/...``).
        log (dict): logged quantities (``log/...``).
        part_dist: optional per-shard particle-count vector for distributed
            appends (the reference's intended ``frame.part_dist``;
            reference: pgsd/pgsd/hoomd.py:598-599).
    """

    def __init__(self, num_procs=0):
        self.configuration = ConfigurationData()
        self.particles = ParticleData()
        self.bonds = BondData(2)
        self.angles = BondData(3)
        self.dihedrals = BondData(4)
        self.impropers = BondData(4)
        self.pairs = BondData(2)
        self.constraints = ConstraintData()
        self.state = {}
        self.log = {}
        self.num_procs = num_procs
        self.part_dist = None

    def validate(self):
        """Validate all contained frame data."""
        self.configuration.validate()
        self.particles.validate()
        self.bonds.validate()
        self.angles.validate()
        self.dihedrals.validate()
        self.impropers.validate()
        self.pairs.validate()
        self.constraints.validate()


#: upstream-GSD-compatible alias
Snapshot = Frame


def _encode_string_list(strings):
    """Encode list[str] as a fixed-width int8 byte matrix chunk.

    (reference: pgsd/pgsd/hoomd.py:621-630)
    """
    data = list(strings)
    wid = max(len(w.encode("utf-8")) for w in data) + 1 if data else 1
    b = numpy.array(
        [w.encode("utf-8") for w in data], dtype=numpy.dtype((bytes, wid))
    )
    return b.view(dtype=numpy.int8).reshape(len(b), wid)


def _decode_string_list(matrix):
    """Decode a fixed-width int8 byte matrix back into list[str].

    (reference: pgsd/pgsd/hoomd.py:817-819)
    """
    tmp = matrix.view(dtype=numpy.dtype((bytes, matrix.shape[1])))
    tmp = tmp.reshape([matrix.shape[0]])
    return [b.rstrip(b"\x00").decode("utf-8") for b in tmp]


class _TrajectoryView:
    """Lazy sequence of frames selected by an index range.

    A single sized sequence class covers slicing, nested slicing, and
    iteration (the reference spreads this over a separate iterable and
    view pair; behavior parity: pgsd/pgsd/hoomd.py:471-512).  Frames are
    read on access, never cached here.
    """

    def __init__(self, trajectory, indices):
        self._trajectory = trajectory
        self._indices = indices

    def __len__(self):
        return len(self._indices)

    def __iter__(self):
        return _FrameIter(self._trajectory, self._indices)

    def __getitem__(self, key):
        if isinstance(key, slice):
            return _TrajectoryView(self._trajectory, self._indices[key])
        return self._trajectory[self._indices[key]]


class _FrameIter:
    """Sized frame iterator: ``len(iter(traj))`` works, as it does in
    the reference (its iterable defines ``__len__``,
    pgsd/pgsd/hoomd.py:486-488) - progress wrappers rely on it."""

    def __init__(self, trajectory, indices):
        self._trajectory = trajectory
        self._it = iter(indices)
        self._remaining = len(indices)

    def __iter__(self):
        return self

    def __next__(self):
        frame = self._trajectory[next(self._it)]
        self._remaining -= 1
        return frame

    def __len__(self):
        return max(self._remaining, 0)


class HOOMDTrajectory:
    """Read and write hoomd schema trajectories.

    Args:
        file: a :class:`tpgsd_torch.fl.PGSDFile` or :class:`tpgsd.pypgsd.PGSDFile`
            (duck-typed; reference: pgsd/pgsd/hoomd.py:515-544).
    """

    def __init__(self, file):
        self._file = file
        self._initial_frame = None

        logger.info("opening HOOMDTrajectory: %s", file)

        if self.file.schema != "hoomd":
            raise RuntimeError(
                "GSD file is not a hoomd schema file: " + str(self.file)
            )
        version = self.file.schema_version
        if not ((1, 0) <= version < (2, 0)):
            raise RuntimeError(
                "Incompatible hoomd schema version "
                + str(version)
                + " in: "
                + str(self.file)
            )

        logger.info("found %d frames", len(self))

    @property
    def file(self):
        """The file handle."""
        return self._file

    def __len__(self):
        return self.file.nframes

    def append(self, frame):
        """Append a frame to the trajectory.

        Writes all non-``None`` fields that differ from both the initial
        frame and the schema default (so unchanged data is materialized on
        read from frame 0 or defaults instead of being stored again).

        Per-particle chunks of a distributed frame (``frame.part_dist``
        set) carry the per-shard row-count vector so every host writes its
        stripe at the right offset; scalar chunks are controller-only
        (the reference's intended design: pgsd/pgsd/hoomd.py:574-642).

        Args:
            frame (Frame): frame to append.
        """
        logger.debug("Appending frame to hoomd trajectory: %s", self.file)

        frame.validate()

        # a reference frame 0 detects chunks that need not be written
        if self._initial_frame is None and len(self) > 0:
            self._read_frame(0)

        import contextlib

        batch = getattr(self.file, "batched_writes", None)
        with batch() if batch is not None else contextlib.nullcontext():
            self._append_chunks(frame)

        self.file.end_frame()

    def _append_chunks(self, frame):
        for path in _CONTAINERS:
            container = getattr(frame, path)
            for name in container._default_value:
                if not self._should_write(path, name, frame):
                    continue
                logger.debug("writing data chunk: %s/%s", path, name)
                data = getattr(container, name)

                write_all = True
                offset = frame.part_dist if path == "particles" else None

                if name == "N":
                    if path == "particles" and frame.part_dist is not None:
                        # distributed frame: N is the global particle count
                        # (reference intent: pgsd/pgsd/hoomd.py:608-612)
                        data = int(numpy.asarray(frame.part_dist).sum())
                    data = numpy.array([data], dtype=numpy.uint32)
                    write_all, offset = False, None
                elif name == "step":
                    data = numpy.array([data], dtype=numpy.uint64)
                    write_all, offset = False, None
                elif name == "dimensions":
                    data = numpy.array([data], dtype=numpy.uint8)
                    write_all, offset = False, None
                elif name == "box":
                    write_all, offset = False, None
                elif name in ("types", "type_shapes"):
                    if name == "type_shapes":
                        data = [json.dumps(shape_dict) for shape_dict in data]
                    data = _encode_string_list(data)
                    write_all, offset = False, None

                self.file.write_chunk(
                    path + "/" + name, data, offset=offset, write_all=write_all
                )

        for state, data in frame.state.items():
            self.file.write_chunk("state/" + state, numpy.asarray(data))

        for log, data in frame.log.items():
            self.file.write_chunk("log/" + log, numpy.asarray(data))

    def _should_write(self, path, name, frame):
        """Decide whether chunk ``path/name`` must land in the file.

        A chunk is stored only when the read side could not reconstruct
        it: the value must differ from frame 0 (the reader's first
        fallback) and, when frame 0 never stored the chunk, from the
        schema default (the reader's second fallback).  Behavior parity
        with the reference's intended skip logic
        (pgsd/pgsd/hoomd.py:654-694).
        """
        value = getattr(getattr(frame, path), name)
        if value is None:
            return False

        # string-list fields compare as plain Python lists; array fields
        # broadcast-compare so a scalar default matches any N
        listlike = name in ("types", "type_shapes")

        if self._initial_frame is not None:
            anchor = getattr(getattr(self._initial_frame, path), name)
            same = (
                anchor == value
                if listlike
                else numpy.array_equal(anchor, value)
            )
            if same:
                logger.debug("skip %s/%s: equals frame 0", path, name)
                return False

        default = getattr(frame, path)._default_value[name]
        is_default = (
            value == default
            if listlike
            else numpy.array_equiv(value, default)
        )
        if not is_default:
            return True
        # default-valued data still needs writing when frame 0 pinned a
        # different value on disk: the reader would otherwise inherit
        # frame 0 instead of the default
        written_at_0 = self.file.chunk_exists(
            frame=0, name=f"{path}/{name}", write_all=False
        )
        if not written_at_0:
            logger.debug("skip %s/%s: schema default", path, name)
        return written_at_0

    def extend(self, iterable):
        """Append every :class:`Frame` from ``iterable``."""
        for item in iterable:
            self.append(item)

    def truncate(self):
        """Remove all frames from the file.

        The reference disables this (pgsd/pgsd/pgsd.h:459); tpgsd restores
        the capability by re-initializing the file in place.
        """
        self.file.truncate()
        self._initial_frame = None

    def close(self):
        """Close the file."""
        self.file.close()
        del self._initial_frame

    def flush(self):
        """Flush all buffered frames to the file."""
        self._file.flush()

    def read_frame(self, idx):
        """Deprecated alias for ``trajectory[idx]``."""
        warnings.warn("Deprecated, use trajectory[idx]", DeprecationWarning)
        return self._read_frame(idx)

    def _read_chunk_scalar(self, idx, name):
        return self.file.read_chunk(frame=idx, name=name)

    def _read_frame(self, idx):
        """Read frame ``idx`` with frame-0 fallback and default materialization.

        Chunks absent at ``idx`` take frame 0's value; absent there too,
        the schema default.  Default/fallback arrays are non-writable
        (reference: pgsd/pgsd/hoomd.py:724-902).
        """
        if idx >= len(self):
            raise IndexError

        logger.debug("reading frame %d from: %s", idx, self.file)

        if self._initial_frame is None and idx != 0:
            self._read_frame(0)

        snap = Frame()

        # prefetch: one batched positioned read for the whole frame when
        # the file layer supports it (tpgsd_torch.fl does; duck-typed handles
        # fall back to per-chunk reads)
        prefetch_fn = getattr(self.file, "read_all_chunks", None)
        chunks = prefetch_fn(idx) if prefetch_fn is not None else None

        def _exists(name):
            if chunks is not None:
                return name in chunks
            return self.file.chunk_exists(frame=idx, name=name, write_all=False)

        def _read(name):
            if chunks is not None:
                return chunks[name]
            return self.file.read_chunk(frame=idx, name=name)

        # configuration
        if _exists("configuration/step"):
            snap.configuration.step = _read("configuration/step")[0]
        elif self._initial_frame is not None:
            snap.configuration.step = self._initial_frame.configuration.step
        else:
            snap.configuration.step = ConfigurationData._default_value["step"]

        if _exists("configuration/dimensions"):
            snap.configuration.dimensions = _read("configuration/dimensions")[0]
        elif self._initial_frame is not None:
            snap.configuration.dimensions = self._initial_frame.configuration.dimensions
        else:
            snap.configuration.dimensions = ConfigurationData._default_value["dimensions"]

        if _exists("configuration/box"):
            snap.configuration.box = _read("configuration/box")
        elif self._initial_frame is not None:
            snap.configuration.box = self._initial_frame.configuration.box
        else:
            snap.configuration.box = ConfigurationData._default_value["box"]

        # containers with N/types/per-row fields
        for path in _CONTAINERS[1:]:
            container = getattr(snap, path)
            initial_frame_container = None
            if self._initial_frame is not None:
                initial_frame_container = getattr(self._initial_frame, path)

            container.N = 0
            if _exists(path + "/N"):
                container.N = _read(path + "/N")[0]
            elif initial_frame_container is not None:
                container.N = initial_frame_container.N

            if "types" in container._default_value:
                if _exists(path + "/types"):
                    tmp = _read(path + "/types")
                    container.types = _decode_string_list(tmp)
                elif initial_frame_container is not None:
                    container.types = initial_frame_container.types
                else:
                    container.types = container._default_value["types"]

            if "type_shapes" in container._default_value and path == "particles":
                if _exists(path + "/type_shapes"):
                    tmp = _read(path + "/type_shapes")
                    container.type_shapes = [
                        json.loads(s) for s in _decode_string_list(tmp)
                    ]
                elif initial_frame_container is not None:
                    container.type_shapes = initial_frame_container.type_shapes
                else:
                    container.type_shapes = container._default_value["type_shapes"]

            for name in container._default_value:
                if name in ("N", "types", "type_shapes"):
                    continue
                if _exists(path + "/" + name):
                    container.__dict__[name] = _read(path + "/" + name)
                else:
                    if (
                        initial_frame_container is not None
                        and initial_frame_container.N == container.N
                    ):
                        # fall back to frame 0
                        container.__dict__[name] = initial_frame_container.__dict__[name]
                    else:
                        # materialize the schema default
                        tmp = numpy.array([container._default_value[name]])
                        s = list(tmp.shape)
                        s[0] = int(container.N)
                        container.__dict__[name] = numpy.empty(shape=s, dtype=tmp.dtype)
                        container.__dict__[name][:] = tmp
                    if isinstance(container.__dict__[name], numpy.ndarray):
                        container.__dict__[name].flags.writeable = False

        # state data (with frame-0 fallback like everything else)
        for state in self.file.find_matching_chunk_names("state/", False):
            if _exists(state):
                snap.state[state[6:]] = _read(state)
            elif self._initial_frame is not None and state[6:] in self._initial_frame.state:
                snap.state[state[6:]] = self._initial_frame.state[state[6:]]

        # log data.  The frame-0 fallback is guarded by membership: a
        # quantity first logged at frame k > 0 simply has no value in
        # earlier/omitting frames (the reference indexes frame 0
        # unconditionally and crashes with KeyError on such files,
        # reference: pgsd/pgsd/hoomd.py:885-896 - see docs/api.md
        # "better than the reference" ledger).
        for log in self.file.find_matching_chunk_names("log/", False):
            if _exists(log):
                snap.log[log[4:]] = _read(log)
            elif (
                self._initial_frame is not None
                and log[4:] in self._initial_frame.log
            ):
                snap.log[log[4:]] = self._initial_frame.log[log[4:]]

        if self._initial_frame is None and idx == 0:
            self._initial_frame = snap

        return snap

    def __getitem__(self, key):
        """Index frames with ints, negative ints, or slices (list semantics)."""
        if isinstance(key, slice):
            return _TrajectoryView(self, range(*key.indices(len(self))))
        elif isinstance(key, int):
            if key < 0:
                key += len(self)
            if key >= len(self) or key < 0:
                raise IndexError()
            return self._read_frame(key)
        else:
            raise TypeError

    def __iter__(self):
        return iter(_TrajectoryView(self, range(len(self))))

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        self.file.close()

    def __getstate__(self):
        """Pickle via the (read-mode) file handle."""
        return {"file": self._file}

    def __setstate__(self, state):
        self._file = state["file"]
        self._initial_frame = None


def open(name, mode="r", comm=None):
    """Open a hoomd schema GSD file.

    Args:
        name (str): file path.
        mode (str): 'r', 'r+', 'w', 'x', or 'a' (see :func:`tpgsd_torch.fl.open`).
        comm: optional multi-host communicator.

    Returns:
        :class:`HOOMDTrajectory`.

    (reference: pgsd/pgsd/hoomd.py:943-989)
    """
    f = fl.open(
        name=str(name),
        mode=mode,
        application="tpgsd_torch.hoomd " + version,
        schema="hoomd",
        schema_version=[1, 4],
        comm=comm,
    )
    return HOOMDTrajectory(f)


def read_log(name, scalar_only=False):
    """Read ``log/*`` quantities into a dict of time-series arrays.

    Includes :chunk:`configuration/step` plus all ``log/*`` chunks; a
    quantity must keep the same shape in every frame
    (reference: pgsd/pgsd/hoomd.py:992-1075).

    Args:
        name (str): file path.
        scalar_only (bool): include only scalar quantities.

    Returns:
        dict mapping chunk name to an array with the leading axis = frame.
    """
    with fl.open(name=str(name), mode="r", schema="hoomd") as f:
        wanted = ["configuration/step", *f.find_matching_chunk_names("log/")]
        if len(wanted) == 1:
            warnings.warn("No logged data in file: " + str(name), RuntimeWarning)
        if f.nframes == 0:
            return {"configuration/step": numpy.zeros(0, dtype=numpy.uint64)}

        # a quantity qualifies when frame 0 stores it (configuration/step
        # always qualifies, defaulting to 0); its frame-0 value also fills
        # any later frame that omits the chunk - the same sticky-frame-0
        # semantics as the frame reader
        frame0 = f.read_all_chunks(0, names=wanted)
        fill = {}
        dropped = []
        for nm in wanted:
            v = frame0.get(nm)
            if v is None:
                if nm != "configuration/step":
                    dropped.append(nm)
                    continue
                v = numpy.zeros(1, dtype=numpy.uint64)
            if scalar_only and v.shape[0] != 1:
                continue
            fill[nm] = v
        if dropped:
            # the reference drops these silently
            # (reference: pgsd/pgsd/hoomd.py:1045-1050); name them instead
            warnings.warn(
                "read_log skipped quantities not logged at frame 0: "
                + ", ".join(sorted(dropped)),
                RuntimeWarning,
            )

        # one batched positioned read per frame, restricted to the log
        # quantities (never the frame's bulk particle data) - replaces
        # the reference's chunk_exists/read_chunk cascade per quantity
        # per frame
        columns = {nm: [v] for nm, v in fill.items()}
        for idx in range(1, f.nframes):
            present = f.read_all_chunks(idx, names=columns.keys())
            for nm, col in columns.items():
                col.append(present.get(nm, fill[nm]))

    out = {}
    for nm, col in columns.items():
        if fill[nm].shape[0] == 1:
            # length-1 rows flatten to a scalar time series
            out[nm] = numpy.array([row[0] for row in col])
        else:
            out[nm] = numpy.stack(col)
    return out
