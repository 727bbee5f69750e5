"""Port of the reference's point-algebra tests
(``tests/test_dtypes.cu``)."""
import numpy as np

from helpers import isclose
from yalla_tpu import Float3, Float4, make_pt


def test_float3_ops():
    x = Float3(1.0, 2.0, 3.0)
    y = Float3(5.0, 4.0, 3.0)
    s = x + y
    assert (s.x, s.y, s.z) == (6, 6, 6)
    d = x - y
    assert (d.x, d.y, d.z) == (-4, -2, 0)
    m = y * 2
    assert (m.x, m.y, m.z) == (10, 8, 6)
    m = 3 * x
    assert (m.x, m.y, m.z) == (3, 6, 9)
    q = x / 3
    assert isclose(q.x, 1 / 3) and isclose(q.y, 2 / 3) and isclose(q.z, 1)
    n = -x
    assert (n.x, n.y, n.z) == (-1, -2, -3)


def test_float4_ops():
    x = Float4(1.0, 2.0, 3.0, 4.0)
    y = Float4(5.0, 4.0, 3.0, 2.0)
    s = x + y
    assert (s.x, s.y, s.z, s.w) == (6, 6, 6, 6)
    m = y * 2
    assert m.w == 4


def test_make_pt():
    MyFloat4 = make_pt("My_float4", "w")
    x = MyFloat4(1.0, 2.0, 3.0, 4.0)
    y = MyFloat4(5.0, 4.0, 3.0, 2.0)
    s = x + y
    assert (s.x, s.y, s.z, s.w) == (6, 6, 6, 6)
    # memoized class identity (pytree structure stability under jit)
    assert make_pt("My_float4", "w") is MyFloat4
    # defaults to zero like Pt{0}
    z = MyFloat4()
    assert (z.x, z.y, z.z, z.w) == (0, 0, 0, 0)


def test_batched_fields():
    Cell = make_pt("CellT", "u")
    a = Cell(x=np.ones(4), y=np.zeros(4), z=np.zeros(4), u=np.full(4, 2.0))
    b = a * 2.0 + a
    assert np.allclose(np.asarray(b.u), 6.0)
    assert b.xyz.shape == (4, 3)
