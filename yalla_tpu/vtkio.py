"""Legacy-ASCII VTK output/input for ParaView, plus wall-clock reporting.

Rebuild of ``include/vtk.cuh``: ``Vtk_output`` writes
``<dir>/<base_name>_<step>.vtk`` POLYDATA time series (positions +
VERTICES, LINES for links, SCALARS fields/properties, NORMALS polarity,
optional bool mask); ``Vtk_input`` restores positions, polarity, fields,
and properties -- VTK files double as checkpoints
(cf. ``examples/intercalation_w_gradient.cu:179-205``).

Formatting is vectorized through numpy; writing happens on the host, off
the device hot path.  With ``async_write=True`` every ``write_*`` call
captures references to the (immutable) device buffers and enqueues the
device->host transfer + formatting + file write on a single worker thread,
so frame t serializes while the device computes frame t+1 -- the rebuild
of the reference's explicit I/O thread (``examples/branching.cu:263-281``;
FIFO ordering on one worker preserves the required section order within
each .vtk file).
"""
from __future__ import annotations

import io
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .polarity import DEFAULT_AXIS

__all__ = ["Vtk_output", "Vtk_input"]


def _fmt_rows(arr):
    """ASCII rows for an [n, k] float array; native C++ serializer when
    available (an order of magnitude faster than Python formatting at
    500k-point frames), numpy fallback otherwise."""
    from . import _native
    text = _native.format_rows(np.asarray(arr, np.float32))
    if text is not None:
        return text
    out = io.StringIO()
    np.savetxt(out, arr, fmt="%.6g", delimiter=" ")
    return out.getvalue()


# device->host prefix-transfer bucket: growth models carry n_pad sized
# for the FINAL population, and pulling whole padded channels costs more
# than the frame's compute when the live count is small.  Rounding the transfer length up to a bucket
# keeps the number of distinct (cached) device slice programs bounded.
_TRANSFER_BUCKET = 4096


def _host_prefix(a, n):
    """First ``n`` entries of ``a`` on host, transferring only the
    leading bucket of a device array instead of its full capacity."""
    if getattr(a, "__module__", "").startswith("numpy") or \
            isinstance(a, np.ndarray):
        return np.asarray(a)[:n]
    m = a.shape[0]
    nb = min(m, -(-max(int(n), 1) // _TRANSFER_BUCKET) * _TRANSFER_BUCKET)
    return np.asarray(a[:nb])[:n]


class Vtk_output:
    """Write one .vtk file per step (ref vtk.cuh:29-214).

    With ``async_write=True``, every ``write_*`` call returns immediately:
    it captures references to the immutable device buffers and enqueues
    transfer + formatting + write on one worker thread (frame t writes
    while the device computes t+1, ref branching.cu:263-281).  At most
    ``max_queue`` jobs are in flight; ``close()`` (or the context manager
    exit) drains the queue and re-raises any worker error.
    """

    def __init__(self, base_name, output_path="output/", verbose=True,
                 async_write=False, max_queue=8):
        self.base_name = base_name
        self.output_dir = output_path if output_path.endswith("/") \
            else output_path + "/"
        os.makedirs(self.output_dir, exist_ok=True)
        self.verbose = verbose
        self.time_step = 0
        self.n_points = 0
        self._frame = {"mask": None, "n_written": 0}
        self._current_path = None
        self._point_data_started = False
        self._t0 = time.time()
        self._pool = ThreadPoolExecutor(
            1, thread_name_prefix=f"vtk-{base_name}") if async_write else None
        self._pending: deque = deque()
        self._max_queue = max_queue

    # -- async plumbing ------------------------------------------------------
    def _submit(self, job):
        if self._pool is None:
            job()
            return
        while len(self._pending) >= self._max_queue:
            self._pending.popleft().result()  # backpressure + error check
        self._pending.append(self._pool.submit(job))

    def drain(self):
        """Block until all queued writes hit disk (re-raises worker errors)."""
        while self._pending:
            self._pending.popleft().result()

    def _dev_field(self, points, field):
        """Capture a per-point array for a write job.  Sync mode keeps the
        reference semantics (read the host mirror, fresh from the
        ``copy_to_host`` in ``write_positions``); async mode captures the
        immutable device array without synchronizing (snapshotting the host
        mirror only if there is no device state)."""
        if self._pool is None:
            return getattr(points.h_X, field)
        d_X = getattr(points, "d_X", None)
        if d_X is not None:
            return getattr(d_X, field)
        return np.array(getattr(points.h_X, field))

    # -- positions (must be written first, ref vtk.cuh:93-135) --------------
    def write_positions(self, points, mask=None):
        if self._pool is None:
            points.copy_to_host()
            n = points.h_n
            xs = [points.h_X.x, points.h_X.y, points.h_X.z]
        else:
            if getattr(points, "d_X", None) is None:
                points.copy_to_device()
            n = points.get_d_n()
            xs = [points.d_X.x, points.d_X.y, points.d_X.z]
        self.n_points = n
        path = f"{self.output_dir}{self.base_name}_{self.time_step}.vtk"
        self._current_path = path
        frame = {}
        self._frame = frame
        base_name = self.base_name

        def job():
            m = None if mask is None else np.asarray(mask)[:n].astype(bool)
            sel = slice(None) if m is None else m
            xyz = np.stack([_host_prefix(a, n) for a in xs], axis=1)[sel]
            n_write = xyz.shape[0]
            frame["mask"] = m
            frame["n_written"] = n_write
            with open(path, "w") as f:
                f.write("# vtk DataFile Version 3.0\n")
                f.write(f"{base_name}\n")
                f.write("ASCII\nDATASET POLYDATA\n")
                f.write(f"\nPOINTS {n_write} float\n")
                f.write(_fmt_rows(xyz))
                f.write(f"\nVERTICES {n_write} {2 * n_write}\n")
                from . import _native
                verts = _native.format_vertices(n_write)
                f.write(verts if verts is not None
                        else "".join(f"1 {i}\n" for i in range(n_write)))

        self._submit(job)
        self._point_data_started = False
        self.time_step += 1
        if self.verbose:
            print(f"Integrating {self.base_name}, {self.time_step} steps "
                  f"done ({n} points)        ", end="\r", flush=True)

    @staticmethod
    def _point_data_header(f, started, frame):
        if not started:
            f.write(f"\nPOINT_DATA {frame['n_written']}\n")

    def _begin_point_data(self):
        """Caller-side bookkeeping; the actual count is resolved by the
        worker (jobs run FIFO, so the positions job has filled the frame)."""
        started = self._point_data_started
        self._point_data_started = True
        return started, self._frame, self._current_path

    # -- links (if written, second; ref vtk.cuh:137-145) --------------------
    def write_links(self, links):
        if self._pool is None:
            links.copy_to_host()
            m = links.h_n
            a, b = links.h_a, links.h_b
        else:
            m = links.get_d_n()
            a, b = links.d_a, links.d_b
        path = self._current_path

        def job():
            ha, hb = _host_prefix(a, m), _host_prefix(b, m)
            with open(path, "a") as f:
                f.write(f"\nLINES {m} {3 * m}\n")
                from . import _native
                lines = _native.format_lines(ha, hb)
                if lines is not None:
                    f.write(lines)
                else:
                    ab = np.stack([np.full(m, 2), ha, hb], axis=1)
                    np.savetxt(f, ab, fmt="%d", delimiter=" ")

        self._submit(job)

    # -- extra Pt fields (ref vtk.cuh:147-166) -------------------------------
    def write_field(self, points, data_name="w", field=None):
        field = field or data_name
        src = self._dev_field(points, field)
        n = self.n_points
        started, frame, path = self._begin_point_data()

        def job():
            vals = _host_prefix(src, n)
            if frame["mask"] is not None:
                vals = vals[frame["mask"]]
            with open(path, "a") as f:
                self._point_data_header(f, started, frame)
                f.write(f"SCALARS {data_name} float\nLOOKUP_TABLE default\n")
                f.write(_fmt_rows(vals[:, None]))

        self._submit(job)

    # -- polarity as NORMALS (ref vtk.cuh:168-187) ---------------------------
    def write_polarity(self, points, data_name="polarity", axis=DEFAULT_AXIS):
        th_src = self._dev_field(points, axis[0])
        ph_src = self._dev_field(points, axis[1])
        n = self.n_points
        started, frame, path = self._begin_point_data()

        def job():
            th = _host_prefix(th_src, n)
            ph = _host_prefix(ph_src, n)
            nx = np.sin(th) * np.cos(ph)
            ny = np.sin(th) * np.sin(ph)
            nz = np.where((th == 0) & (ph == 0), 0.0, np.cos(th))
            normals = np.stack([nx, ny, nz], axis=1)
            if frame["mask"] is not None:
                normals = normals[frame["mask"]]
            with open(path, "a") as f:
                self._point_data_header(f, started, frame)
                f.write(f"NORMALS {data_name} float\n")
                f.write(_fmt_rows(normals))

        self._submit(job)

    # -- whole frame in one transfer ------------------------------------------
    def write_frame(self, points, mask=None, polarity=False,
                    polarity_axis=DEFAULT_AXIS, fields=(), properties=()):
        """Positions + polarity + fields + properties with ONE device->host
        transfer (two when int properties are present).

        The per-array ``write_*`` calls each pull their channels separately,
        and every pull is its own device-to-host round trip -- for small
        tissues more than the device compute of a whole frame.  This packs all
        requested channels into one stacked device array (a single cached
        slice program per transfer bucket) and writes every section from
        the one pulled buffer.

        fields: Pt field names -> SCALARS float sections.
        properties: ``Property`` objects or ``(name, device_array, dtype)``
            tuples; int dtypes ride a second (int32) stacked pull.
        """
        import jax.numpy as jnp

        if getattr(points, "d_X", None) is None:
            points.copy_to_device()
        n = points.get_d_n()
        d = points.d_X

        fcols, fsections = [d.x, d.y, d.z], []
        if polarity:
            fcols += [getattr(d, polarity_axis[0]),
                      getattr(d, polarity_axis[1])]
        for name in fields:
            fsections.append((name, len(fcols)))
            fcols.append(getattr(d, name))
        icols, psections = [], []
        for p in properties:
            if isinstance(p, tuple):
                name, arr, dtype = p
            else:
                name, dtype = p.name, p.dtype
                arr = p.d_prop if p.d_prop is not None else p.h_prop
            if np.issubdtype(np.dtype(dtype), np.floating):
                psections.append((name, "float", "f", len(fcols)))
                fcols.append(jnp.asarray(arr).astype(jnp.float32))
            else:
                psections.append((name, "int", "i", len(icols)))
                icols.append(jnp.asarray(arr).astype(jnp.int32))
        # transfer length: the bucketed live prefix, clamped to the
        # shortest column (properties may carry a smaller padding)
        nb = -(-max(int(n), 1) // _TRANSFER_BUCKET) * _TRANSFER_BUCKET
        nb = min([nb] + [c.shape[0] for c in fcols + icols])
        fbuf = jnp.stack([c[:nb] for c in fcols], axis=1)
        ibuf = jnp.stack([c[:nb] for c in icols], axis=1) if icols else None

        self.n_points = n
        path = f"{self.output_dir}{self.base_name}_{self.time_step}.vtk"
        self._current_path = path
        frame = {}
        self._frame = frame
        base_name = self.base_name
        self._point_data_started = True

        def job():
            F = np.asarray(fbuf)[:n]
            I = np.asarray(ibuf)[:n] if ibuf is not None else None
            m = None if mask is None else np.asarray(mask)[:n].astype(bool)
            sel = slice(None) if m is None else m
            F = F[sel]
            I = I[sel] if I is not None else None
            n_write = F.shape[0]
            frame["mask"] = m
            frame["n_written"] = n_write
            from . import _native
            with open(path, "w") as f:
                f.write("# vtk DataFile Version 3.0\n")
                f.write(f"{base_name}\n")
                f.write("ASCII\nDATASET POLYDATA\n")
                f.write(f"\nPOINTS {n_write} float\n")
                f.write(_fmt_rows(F[:, :3]))
                f.write(f"\nVERTICES {n_write} {2 * n_write}\n")
                verts = _native.format_vertices(n_write)
                f.write(verts if verts is not None
                        else "".join(f"1 {i}\n" for i in range(n_write)))
                f.write(f"\nPOINT_DATA {n_write}\n")
                if polarity:
                    th, ph = F[:, 3], F[:, 4]
                    nx = np.sin(th) * np.cos(ph)
                    ny = np.sin(th) * np.sin(ph)
                    nz = np.where((th == 0) & (ph == 0), 0.0, np.cos(th))
                    f.write("NORMALS polarity float\n")
                    f.write(_fmt_rows(np.stack([nx, ny, nz], axis=1)))
                for name, col in fsections:
                    f.write(f"SCALARS {name} float\nLOOKUP_TABLE default\n")
                    f.write(_fmt_rows(F[:, col][:, None]))
                for name, ptype, kind, col in psections:
                    f.write(f"SCALARS {name} {ptype}\n"
                            f"LOOKUP_TABLE default\n")
                    if kind == "i":
                        text = _native.format_ints(
                            np.ascontiguousarray(I[:, col]))
                        f.write(text if text is not None else
                                "".join(f"{int(v)}\n" for v in I[:, col]))
                    else:
                        f.write(_fmt_rows(F[:, col][:, None]))

        self._submit(job)
        self.time_step += 1
        if self.verbose:
            print(f"Integrating {self.base_name}, {self.time_step} steps "
                  f"done ({n} points)        ", end="\r", flush=True)

    # -- properties (ref vtk.cuh:189-214) -------------------------------------
    def write_property(self, prop):
        if self._pool is None:
            src = prop.copy_to_host()
        else:
            src = prop.d_prop if prop.d_prop is not None \
                else np.array(prop.h_prop)
        n = self.n_points
        dtype = prop.dtype
        name = prop.name
        started, frame, path = self._begin_point_data()

        def job():
            vals = _host_prefix(src, n).astype(dtype)
            if frame["mask"] is not None:
                vals = vals[frame["mask"]]
            ptype = "float" if np.issubdtype(dtype, np.floating) else "int"
            with open(path, "a") as f:
                self._point_data_header(f, started, frame)
                f.write(f"SCALARS {name} {ptype}\nLOOKUP_TABLE default\n")
                if ptype == "int":
                    from . import _native
                    text = _native.format_ints(np.asarray(vals, np.int32))
                    f.write(text if text is not None
                            else "".join(f"{int(v)}\n" for v in vals))
                else:
                    f.write(_fmt_rows(np.asarray(vals, float)[:, None]))

        self._submit(job)

    # -- wall-clock report (ref vtk.cuh:75-91) --------------------------------
    def close(self):
        try:
            self.drain()
        finally:
            # a failed write job must not leak the worker thread or the
            # jobs queued behind it
            self._pending.clear()
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None
        if not self.verbose:
            return
        self.verbose = False  # report once
        duration = int(time.time() - self._t0)
        if duration < 60:
            t = f"{duration} seconds"
        elif duration < 3600:
            t = f"{duration // 60}m {duration % 60}s"
        else:
            t = f"{duration // 3600}h {duration % 3600}m"
        print(f"Integrating {self.base_name}, {t} taken "
              f"({self.n_points} points).        ")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        # Mirror the reference's destructor report; safe if already closed.
        # Also drains any queued async writes so no frame is lost at GC.
        try:
            if (self.verbose and self.time_step > 0) or self._pending:
                self.close()
                self.verbose = False
        except Exception:
            pass


class Vtk_input:
    """Read back positions/polarity/fields/properties
    (ref vtk.cuh:217-378)."""

    def __init__(self, file_name):
        self.file_name = file_name
        with open(file_name) as f:
            self._lines = f.read().splitlines()
        self.n_points = None
        for line in self._lines[:10]:
            items = line.split()
            if items and items[0] == "POINTS":
                self.n_points = int(items[1])
                break
        assert self.n_points is not None, "POINTS header not found"

    def _find_entry(self, kw1, kw2):
        """Line index right after the '<kw1> <kw2>' header
        (ref vtk.cuh:259-286; skips the 4 header lines)."""
        for idx in range(4, len(self._lines)):
            items = self._lines[idx].split()
            if len(items) > 1 and items[0] == kw1 and items[1] == kw2:
                return idx + 1
        raise KeyError(f"{kw1} {kw2} not found in {self.file_name}")

    def _read_floats(self, start, n, width):
        # float64: must hold int32 properties exactly (f32 would round >2^24)
        from . import _native
        text = "\n".join(self._lines[start:start + n])
        vals = _native.parse_doubles(text, n * width)
        if vals is not None and len(vals) == n * width:
            return vals.reshape(n, width)
        vals = []
        idx = start
        while len(vals) < n * width:
            vals.extend(float(v) for v in self._lines[idx].split())
            idx += 1
        return np.asarray(vals, np.float64).reshape(n, width)

    def read_positions(self, points):
        start = self._find_entry("POINTS", str(self.n_points))
        xyz = self._read_floats(start, self.n_points, 3)
        n = self.n_points
        points.h_X.x[:n] = xyz[:, 0]
        points.h_X.y[:n] = xyz[:, 1]
        points.h_X.z[:n] = xyz[:, 2]

    def read_polarity(self, points, data_name="polarity", axis=DEFAULT_AXIS):
        """Normals -> (theta, phi).  The reference has a latent bug here
        (clears the parsed line before converting, vtk.cuh:325-328); this
        implements the intended parse-then-convert behaviour."""
        start = self._find_entry("NORMALS", data_name)
        nrm = self._read_floats(start, self.n_points, 3)
        d = np.sqrt((nrm ** 2).sum(axis=1))
        theta = np.where(d == 0, 0.0, np.arccos(np.clip(nrm[:, 2], -1, 1)))
        phi = np.where(d == 0, 0.0, np.arctan2(nrm[:, 1], nrm[:, 0]))
        n = self.n_points
        getattr(points.h_X, axis[0])[:n] = theta
        getattr(points.h_X, axis[1])[:n] = phi

    def read_field(self, points, data_name="w", field=None):
        field = field or data_name
        start = self._find_entry("SCALARS", data_name) + 1  # skip LOOKUP_TABLE
        vals = self._read_floats(start, self.n_points, 1)[:, 0]
        getattr(points.h_X, field)[:self.n_points] = vals

    def read_property(self, prop, prop_name=None):
        prop_name = prop_name or prop.name
        start = self._find_entry("SCALARS", prop_name) + 1
        assert self.n_points <= prop.n_max
        vals = self._read_floats(start, self.n_points, 1)[:, 0]
        prop.h_prop[:self.n_points] = vals.astype(prop.dtype)
