"""Port of the reference's VTK round-trip test
(``tests/test_vtk.cu``): write then read positions,
polarity, fields, and int/float properties."""
import math

import numpy as np

from helpers import isclose
from yalla_tpu import Property, Solution, make_pt
from yalla_tpu.vtkio import Vtk_input, Vtk_output

Po_cell4 = make_pt("Po_cell4", "w", "theta", "phi")
rng = np.random.default_rng(42)


def test_io(tmp_path):
    n_cells = 100
    out_dir = str(tmp_path) + "/"
    w = Solution(Po_cell4, n_cells, solver="tile")
    r = Solution(Po_cell4, n_cells, solver="tile")

    w.h_X.x[:n_cells] = rng.random(n_cells)
    w.h_X.y[:n_cells] = rng.random(n_cells)
    w.h_X.z[:n_cells] = rng.random(n_cells)
    w.h_X.w[:n_cells] = rng.random(n_cells)
    w.h_X.phi[:n_cells] = rng.random(n_cells) * 2 * math.pi - math.pi
    w.h_X.theta[:n_cells] = np.arccos(2 * rng.random(n_cells) - 1)
    w.copy_to_device()

    ints_w = Property(n_cells, "intprop", np.int32)
    floats_w = Property(n_cells, "floatprop", np.float32)
    ints_w.h_prop[:] = rng.integers(0, 2 ** 30, n_cells)
    floats_w.h_prop[:] = rng.random(n_cells)

    output = Vtk_output("test_vtk", out_dir, verbose=False)
    output.write_positions(w)
    output.write_polarity(w)
    output.write_field(w, "w")
    output.write_property(floats_w)
    output.write_property(ints_w)

    inp = Vtk_input(out_dir + "test_vtk_0.vtk")
    inp.read_field(r, "w")
    inp.read_polarity(r)
    inp.read_positions(r)

    assert isclose(w.h_X.x[:n_cells], r.h_X.x[:n_cells]), "Not close in x"
    assert isclose(w.h_X.y[:n_cells], r.h_X.y[:n_cells]), "Not close in y"
    assert isclose(w.h_X.z[:n_cells], r.h_X.z[:n_cells]), "Not close in z"
    assert isclose(w.h_X.w[:n_cells], r.h_X.w[:n_cells]), "Not close in w"
    assert isclose(w.h_X.phi[:n_cells], r.h_X.phi[:n_cells]), \
        "Not close in phi"
    assert isclose(w.h_X.theta[:n_cells], r.h_X.theta[:n_cells]), \
        "Not close in theta"

    ints_r = Property(n_cells, "intprop", np.int32)
    floats_r = Property(n_cells, "floatprop", np.float32)
    inp.read_property(ints_r, "intprop")
    inp.read_property(floats_r, "floatprop")
    assert np.array_equal(ints_w.h_prop, ints_r.h_prop), "Int property"
    assert isclose(floats_w.h_prop, floats_r.h_prop), "Float property"


def test_links_and_mask(tmp_path):
    """LINES block + bool-mask filtering (ref vtk.cuh:99-104, 137-145;
    examples/write_vtk_w_mask.cu)."""
    from yalla_tpu import Float3
    from yalla_tpu.links import Links
    out_dir = str(tmp_path) + "/"
    pts = Solution(Float3, 4, solver="tile")
    pts.h_X.x[:4] = [0, 1, 2, 3]
    pts.copy_to_device()
    links = Links(2)
    links.h_a[:2] = [0, 2]
    links.h_b[:2] = [1, 3]
    links.copy_to_device()

    output = Vtk_output("masked", out_dir, verbose=False)
    output.write_positions(pts)
    output.write_links(links)
    text = open(out_dir + "masked_0.vtk").read()
    assert "LINES 2 6" in text

    mask = np.array([True, False, True, True])
    output.write_positions(pts, mask=mask)
    text = open(out_dir + "masked_1.vtk").read()
    assert "POINTS 3 float" in text


def test_async_write_matches_sync(tmp_path):
    """async_write=True produces byte-identical files to sync mode while
    returning before the data hits disk (the reference's overlapped-I/O
    pattern, branching.cu:263-281)."""
    from yalla_tpu import Float3
    from yalla_tpu.links import Links

    n = 50
    out_dir_s = str(tmp_path) + "/sync/"
    out_dir_a = str(tmp_path) + "/async/"
    pts = Solution(Po_cell4, n, solver="tile")
    pts.h_X.x[:n] = rng.random(n)
    pts.h_X.y[:n] = rng.random(n)
    pts.h_X.z[:n] = rng.random(n)
    pts.h_X.w[:n] = rng.random(n)
    pts.h_X.theta[:n] = np.arccos(2 * rng.random(n) - 1)
    pts.h_X.phi[:n] = rng.random(n) * 2 * math.pi - math.pi
    pts.copy_to_device()
    ints = Property(n, "intprop", np.int32)
    ints.h_prop[:] = rng.integers(0, 100, n)
    ints.copy_to_device()
    links = Links(3)
    links.h_a[:3] = [0, 1, 2]
    links.h_b[:3] = [3, 4, 5]
    links.copy_to_device()
    mask = np.arange(n) % 5 != 0

    for out_dir, async_write in ((out_dir_s, False), (out_dir_a, True)):
        with Vtk_output("t", out_dir, verbose=False,
                        async_write=async_write) as out:
            for _ in range(3):  # multiple frames exercise queue ordering
                out.write_positions(pts, mask=mask)
                out.write_links(links)
                out.write_polarity(pts)
                out.write_field(pts, "w")
                out.write_property(ints)

    for t in range(3):
        a = open(out_dir_s + f"t_{t}.vtk").read()
        b = open(out_dir_a + f"t_{t}.vtk").read()
        assert a == b, f"frame {t} differs between sync and async"


def test_async_write_propagates_errors(tmp_path):
    from yalla_tpu import Float3
    pts = Solution(Float3, 8, solver="tile")
    pts.copy_to_device()
    out = Vtk_output("e", str(tmp_path) + "/", verbose=False,
                     async_write=True)
    out.write_positions(pts)
    out._current_path = "/nonexistent-dir/zz.vtk"  # force a worker error
    out.write_field(pts, "x")
    try:
        out.close()
    except FileNotFoundError:
        pass
    else:
        raise AssertionError("worker error was swallowed")


def test_write_frame_matches_per_array(tmp_path):
    """write_frame (single-transfer fast path) is byte-identical to the
    per-array write sequence, in both sync and async modes."""
    n = 50
    pts = Solution(Po_cell4, n, solver="tile")
    pts.h_X.x[:n] = rng.random(n)
    pts.h_X.y[:n] = rng.random(n)
    pts.h_X.z[:n] = rng.random(n)
    pts.h_X.w[:n] = rng.random(n)
    pts.h_X.theta[:n] = np.arccos(2 * rng.random(n) - 1)
    pts.h_X.phi[:n] = rng.random(n) * 2 * math.pi - math.pi
    pts.copy_to_device()
    ints = Property(n, "intprop", np.int32)
    ints.h_prop[:] = rng.integers(0, 100, n)
    ints.copy_to_device()
    fprop = Property(n, "fprop", np.float32)
    fprop.h_prop[:] = rng.random(n).astype(np.float32)
    fprop.copy_to_device()
    mask = np.arange(n) % 5 != 0

    ref_dir = str(tmp_path) + "/ref/"
    with Vtk_output("t", ref_dir, verbose=False, async_write=True) as out:
        for _ in range(2):
            out.write_positions(pts, mask=mask)
            out.write_polarity(pts)
            out.write_field(pts, "w")
            out.write_property(ints)
            out.write_property(fprop)

    for mode in (False, True):
        got_dir = str(tmp_path) + f"/frame{int(mode)}/"
        with Vtk_output("t", got_dir, verbose=False,
                        async_write=mode) as out:
            for _ in range(2):
                out.write_frame(pts, mask=mask, polarity=True,
                                fields=("w",), properties=(ints, fprop))
        for t in range(2):
            a = open(ref_dir + f"t_{t}.vtk").read()
            b = open(got_dir + f"t_{t}.vtk").read()
            assert a == b, f"frame {t} differs (async={mode})"


def test_write_frame_property_tuple(tmp_path):
    """(name, device_array, dtype) property tuples avoid a host Property
    round trip; ints survive exactly."""
    import jax.numpy as jnp
    n = 20
    pts = Solution(Po_cell4, n, solver="tile")
    pts.h_X.x[:n] = rng.random(n)
    pts.copy_to_device()
    clone = jnp.arange(pts.n_pad, dtype=jnp.int32) * 3
    with Vtk_output("t", str(tmp_path) + "/", verbose=False) as out:
        out.write_frame(pts, properties=(("cl", clone, np.int32),))
    txt = open(str(tmp_path) + "/t_0.vtk").read()
    assert "SCALARS cl int" in txt
    sec = txt.split("LOOKUP_TABLE default\n")[1]
    vals = [int(v) for v in sec.strip().splitlines()[:n]]
    assert vals == [3 * i for i in range(n)]
