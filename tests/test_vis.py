"""Visualization (udvis-equivalent) tests: every plot function renders a
matplotlib figure headlessly on reference case 101 and the color policy
holds (diverging centred at zero for signed facet data, fixed categorical
order for identity)."""
from pathlib import Path

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt
import numpy as np
import pytest

CASE = Path("/root/reference/examples/101")

pytestmark = pytest.mark.skipif(not CASE.exists(), reason="reference absent")


@pytest.fixture(scope="module")
def post():
    from udales_jax.post import UDPost
    return UDPost("101", CASE)


@pytest.fixture(autouse=True)
def _close_figs():
    yield
    plt.close("all")


def test_show_geometry(post):
    fig = post.vis.show_geometry(plot_quiver=True)
    assert fig.axes and fig.axes[0].name == "3d"
    # ground + buildings both present -> two mesh collections + edges
    assert len(fig.axes[0].collections) >= 2


def test_plot_fac_signed_uses_diverging(post):
    nf = post.nfcts
    var = np.linspace(-1.0, 2.0, nf)
    fig = post.vis.plot_fac(var)
    # colorbar present and symmetric about zero
    cbar_ax = fig.axes[-1]
    lo, hi = cbar_ax.get_ylim()
    assert lo == pytest.approx(-hi)


def test_plot_fac_wrong_length_raises(post):
    with pytest.raises(ValueError):
        post.vis.plot_fac(np.zeros(3))


def test_plot_fac_type(post):
    fig = post.vis.plot_fac_type()
    assert fig.axes[0].get_legend() is not None


def test_plot_solid_and_boundary(post):
    fig = post.vis.plot_solid("c")
    assert fig.axes[0].collections
    fig2 = post.vis.plot_fluid_boundary("c")
    assert fig2.axes[0].collections


def test_plot_2dmap(post):
    v = np.random.default_rng(0).random((post.itot, post.jtot))
    fig = post.vis.plot_2dmap(v, labels="test")
    assert fig.axes[0].get_title() == "test"


def test_profiles_and_lscale_and_dz(post, tmp_path):
    fig = post.vis.plot_profiles(save=True, outdir=tmp_path)
    assert (tmp_path / "profiles_101.png").exists()
    assert len(fig.axes) == 5
    post.vis.plot_dz_variation(save=True, outdir=tmp_path)
    assert (tmp_path / "dz_101.png").exists()
    if (CASE / "lscale.inp.101").exists():
        post.vis.plot_lscale()


def test_missing_backend_raises(post):
    with pytest.raises((ImportError, NotImplementedError)):
        post.vis.show_geometry(backend="pyvista")


class TestPlotlyBackend:
    """The plotly backend renders the same Scene primitives; exercised
    through a recording stub since plotly is not bundled in this image."""

    def _stub(self, monkeypatch):
        import sys
        import types
        calls = {"traces": [], "layout": []}

        def trace(kind):
            def make(**kw):
                calls["traces"].append((kind, kw))
                return (kind, kw)
            return make

        class Figure:
            def __init__(self, data=None):
                self.data = data or []

            def update_layout(self, **kw):
                calls["layout"].append(kw)

        go = types.ModuleType("plotly.graph_objects")
        go.Mesh3d = trace("mesh3d")
        go.Scatter3d = trace("scatter3d")
        go.Cone = trace("cone")
        go.Figure = Figure
        plotly = types.ModuleType("plotly")
        plotly.graph_objects = go
        monkeypatch.setitem(sys.modules, "plotly", plotly)
        monkeypatch.setitem(sys.modules, "plotly.graph_objects", go)
        return calls

    def _scene(self):
        from udales_jax.vis import (LineSet, MeshPrimitive, PointSet,
                                    Scene)
        verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                          [0, 0, 1]], float)
        faces = np.array([[0, 1, 2], [0, 2, 3], [0, 1, 4]])
        sc = Scene(title="t")
        sc.meshes.append(MeshPrimitive(verts, faces,
                                       face_values=np.array([1., 2., 3.])))
        sc.meshes.append(MeshPrimitive(verts, faces, solid_color="#888888"))
        sc.lines.append(LineSet(verts, np.array([[0, 1], [1, 2]])))
        sc.points.append(PointSet(verts[:2]))
        return sc

    def test_traces_built(self, monkeypatch):
        from udales_jax.vis import render_scene
        calls = self._stub(monkeypatch)
        fig = render_scene(self._scene(), backend="plotly")
        kinds = [k for k, _ in calls["traces"]]
        assert kinds.count("mesh3d") == 2
        assert kinds.count("scatter3d") == 2   # lines + points
        mesh_kw = calls["traces"][0][1]
        np.testing.assert_allclose(mesh_kw["intensity"], [1.0, 2.0, 3.0])
        assert mesh_kw["intensitymode"] == "cell"
        assert calls["traces"][1][1].get("color") == "#888888"
        # aspectmode data + z floor at 0 (the udvis camera contract)
        assert calls["layout"][0]["scene"]["aspectmode"] == "data"
        assert calls["layout"][0]["scene"]["zaxis"]["range"][0] == 0.0
        assert fig.data

    def test_missing_plotly_raises_import_error(self, monkeypatch):
        import builtins
        import sys
        from udales_jax.vis import render_scene
        monkeypatch.setitem(sys.modules, "plotly", None)
        real_import = builtins.__import__

        def imp(name, *a, **k):
            if name == "plotly":
                raise ImportError("nope")
            return real_import(name, *a, **k)
        monkeypatch.setattr(builtins, "__import__", imp)
        with pytest.raises(ImportError, match="plotly"):
            render_scene(self._scene(), backend="plotly")
