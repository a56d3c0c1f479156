"""UDGeom toolkit tests: splitting, watertightness, volume, repair,
footprint outlines, ground generation, extrusion — the udgeom
(tools/python/udgeom/udgeom.py) operation set."""
from pathlib import Path

import numpy as np
import pytest

from udales_jax.prep.prep import make_box_stl
from udales_jax.prep.stl import read_stl
from udales_jax.prep.udgeom import UDGeom


def box(tmp, name, x0, x1, y0, y1, z1, xlen=32.0, ylen=32.0):
    p = tmp / name
    make_box_stl(p, x0, x1, y0, y1, z1, xlen, ylen)
    return UDGeom(path=p)


class TestBasics:
    def test_area_volume_watertight(self, tmp_path):
        g = box(tmp_path, "b.stl", 4, 12, 4, 12, 6)
        # building walls+roof only (make_box_stl adds floor tiles too);
        # extract the building component
        bs = g.get_buildings()
        assert len(bs) == 1
        b = bs[0]
        # open-bottom box: walls 4*8*6 + roof 8*8
        assert abs(b.total_area - (4 * 8 * 6 + 64)) < 1e-9  # walls+roof
        assert not b.is_watertight()   # bottom face missing
        assert len(b.boundary_edges()) > 0

    def test_volume_closed(self):
        # closed unit cube
        t = []
        for d in range(3):
            for s in (0.0, 1.0):
                a = np.zeros(3); a[d] = s
                u = np.zeros(3); u[(d + 1) % 3] = 1
                v = np.zeros(3); v[(d + 2) % 3] = 1
                q = [a, a + u, a + u + v, a + v]
                if s == 1.0:
                    t.append([q[0], q[1], q[2]]); t.append([q[0], q[2], q[3]])
                else:
                    t.append([q[0], q[2], q[1]]); t.append([q[0], q[3], q[2]])
        g = UDGeom(np.asarray(t))
        assert g.is_watertight()
        assert abs(abs(g.volume()) - 1.0) < 1e-12

    def test_split_two_buildings(self, tmp_path):
        g1 = box(tmp_path, "b1.stl", 2, 6, 2, 6, 4)
        g2 = box(tmp_path, "b2.stl", 10, 14, 10, 14, 8)
        both = UDGeom(np.concatenate([g1.tris, g2.tris]))
        bs = both.get_buildings()
        assert len(bs) == 2
        heights = sorted(b.bounds[1, 2] for b in bs)
        assert heights == [4.0, 8.0]


class TestRepair:
    def test_fix_drops_degenerate_and_duplicates(self, tmp_path):
        g = box(tmp_path, "b.stl", 4, 8, 4, 8, 4)
        bad = np.concatenate([
            g.tris,
            g.tris[:1],                       # duplicate face
            np.zeros((1, 3, 3)),              # degenerate
        ])
        fixed = UDGeom(bad).fix()
        assert fixed.n_faces == g.n_faces

    def test_fix_orients_outward(self, tmp_path):
        g = box(tmp_path, "b.stl", 4, 8, 4, 8, 4)
        b = g.get_buildings()[0]
        flipped = UDGeom(b.tris[:, ::-1])     # all windings reversed
        fixed = flipped.fix()
        # roof normal must point up again
        roof = np.abs(fixed.tris[..., 2] - 4.0).max(axis=1) < 1e-9
        assert (fixed.normals[roof][:, 2] > 0.99).all()


class TestOutlines:
    def test_footprint_loop(self, tmp_path):
        g = box(tmp_path, "b.stl", 4, 12, 6, 10, 5)
        polys = UDGeom(g.get_buildings()[0].tris).footprint_polygons()
        assert len(polys) == 1
        loop = polys[0]
        xs, ys = loop[:, 0], loop[:, 1]
        assert {xs.min(), xs.max()} == {4.0, 12.0}
        assert {ys.min(), ys.max()} == {6.0, 10.0}
        out = g.get_outline()
        assert len(out) >= len(loop)


class TestGeneration:
    def test_add_ground(self, tmp_path):
        g = box(tmp_path, "b.stl", 4, 8, 4, 8, 4)
        b = g.get_buildings()[0]
        withg = b.add_ground(32.0, 32.0, tile=8.0)
        assert withg.n_faces == b.n_faces + 2 * 16
        ground = np.abs(withg.tris[..., 2]).max(axis=1) < 1e-12
        assert ground.sum() == 32

    def test_extrude_to_ground_closes(self, tmp_path):
        g = box(tmp_path, "b.stl", 4, 8, 4, 8, 4)
        b = g.get_buildings()[0]
        # lift the open-bottom box so its rim floats, then extrude down
        lifted = UDGeom(b.tris + np.array([0, 0, 2.0]))
        closed = lifted.extrude_to_ground()
        assert closed.n_faces > lifted.n_faces
        zmin = closed.tris[..., 2].min()
        assert zmin == 0.0


# ---------------------------------------------------------------------------
# check(): mesh diagnostics (tools/python/udgeom/check_mesh.py vocabulary)
# ---------------------------------------------------------------------------

from udales_jax.prep.udgeom import (check, create_canyons, create_cubes,
                                    create_flat_surface,
                                    calculate_independent_surfaces,
                                    find_nonmanifold_regions,
                                    find_touching_regions)


def _clean_box_array():
    return create_cubes(64.0, 64.0, 8.0, 8.0, 16.0, 8.0, 8.0, "AC",
                        edgelength=8.0)


class TestCheckDiagnostics:
    def test_clean_mesh_passes(self):
        r = check(_clean_box_array())
        assert r["valid"], r["issues"]
        assert r["n_duplicate_faces"] == 0
        assert r["n_nonmanifold_edges"] == 0
        assert r["summary"].endswith("no issues found")

    def test_duplicate_faces_diagnosed(self):
        g = _clean_box_array()
        bad = UDGeom(np.concatenate([g.tris, g.tris[5:6], g.tris[5:6]]))
        r = check(bad)
        assert not r["valid"]
        assert r["n_duplicate_faces"] == 2
        assert any("duplicate" in s for s in r["issues"])
        assert len(r["details"]["duplicate_face_groups"]) == 1

    def test_degenerate_and_zero_area_faces(self):
        g = _clean_box_array()
        t = g.tris[0].copy()
        t[1] = t[0]     # collapsed edge -> degenerate + zero area
        bad = UDGeom(np.concatenate([g.tris, t[None]]))
        r = check(bad)
        assert not r["valid"]
        assert r["n_degenerate_faces"] == 1
        assert r["n_zero_area_faces"] == 1
        assert r["details"]["degenerate_face_ids"] == [g.n_faces]

    def test_downward_ground_faces_diagnosed(self):
        g = _clean_box_array()
        ground = g.identify_ground_faces()
        normals = g.normals.copy()
        i = int(np.flatnonzero(ground)[0])
        normals[i] = -normals[i]     # accidental downward ground facet
        r = check(UDGeom(g.tris, normals))
        assert not r["valid"]
        assert r["n_downward_ground_faces"] == 1
        assert r["details"]["downward_ground_bbox"].shape == (2, 3)

    def test_below_ground_vertices_diagnosed(self):
        g = _clean_box_array()
        t = np.array([[[1.0, 1.0, -3.0], [2.0, 1.0, -3.0],
                       [1.5, 2.0, -2.0]]])
        r = check(UDGeom(np.concatenate([g.tris, t])))
        assert not r["valid"]
        assert r["n_below_ground_vertices"] == 3
        assert any("below planar ground" in s for s in r["issues"])

    def test_nonmanifold_fin_diagnosed(self):
        g = _clean_box_array()
        # a fin sharing one roof edge -> that edge carries 3 faces
        roof = g.tris[np.flatnonzero(g.normals[:, 2] > 0.99)[-1]]
        fin = np.array([[roof[0], roof[1],
                         roof[0] + np.array([0.0, 0.0, 5.0])]])
        bad = UDGeom(np.concatenate([g.tris, fin]))
        r = check(bad)
        assert not r["valid"]
        assert r["n_nonmanifold_edges"] >= 1
        regs = r["details"]["nonmanifold_regions"]
        assert regs and regs[0]["n_faces"] >= 3
        assert regs[0]["bbox"].shape == (2, 3)

    def test_tjunction_touching_diagnosed(self):
        # long wall edge vs two half edges: classic hanging-node defect
        quad = np.array([
            [[0, 0, 0], [4, 0, 0], [4, 0, 4]],
            [[0, 0, 0], [4, 0, 4], [0, 0, 4]],
        ], float)
        upper = np.array([
            [[0, 0, 4], [2, 0, 4], [2, 0, 8]],
            [[0, 0, 4], [2, 0, 8], [0, 0, 8]],
            [[2.0000001, 0, 4], [4, 0, 4], [4, 0, 8]],
        ], float)
        r = check(UDGeom(np.concatenate([quad, upper])))
        assert r["n_touching_regions"] >= 1
        assert any("unstitched" in s for s in r["issues"])

    def test_independent_surfaces_reported(self):
        g = _clean_box_array()
        # fully stitched generator output: ONE component (walls weld to
        # the footprint-aligned ground grid)
        r = check(g, require_single_component=True)
        assert r["valid"] and r["n_independent_surfaces"] == 1
        # two floating boxes: two surfaces, flagged under
        # require_single_component
        b = g.get_buildings()[0]
        two = UDGeom(np.concatenate([b.tris,
                                     b.tris + np.array([30.0, 0, 0])]))
        r2 = check(two, require_single_component=True)
        assert not r2["valid"]
        surf = calculate_independent_surfaces(two)
        assert surf["n_surfaces"] == 2
        assert sum(s["n_faces"] for s in surf["surfaces"]) == two.n_faces
        assert any("disconnected" in s for s in r2["issues"])

    def test_open_building_diagnosed(self):
        g = _clean_box_array()
        # delete one roof face: boundary edges appear above ground
        roof = np.flatnonzero(g.normals[:, 2] > 0.99)
        zs = g.tris[roof, :, 2]
        roof = roof[np.all(zs > 1.0, axis=1)]
        keep = np.ones(g.n_faces, bool)
        keep[roof[0]] = False
        r = check(UDGeom(g.tris[keep]))
        assert not r["valid"]
        assert r["n_open_buildings"] == 1

    # every shipped reference STL, with its measured diagnosis: the
    # "invalid" ones are real properties of the shipped meshes (ground
    # sheets with hanging nodes against the buildings; two open-bottom
    # buildings in 101/950) that the preprocessor's w-grid bottom rule
    # and solid fill compensate for — the diagnostics must NAME them,
    # not reject the file
    @pytest.mark.parametrize("case,stl,expect_valid,min_touch", [
        ("001", "flat_ground.stl", True, 0),
        ("002", "geom.002.STL", False, 40),     # canopy posts unstitched
        ("101", "geom.101.STL", False, 100),    # + 2 open-bottom buildings
        ("102", "geom.102.STL", True, 0),
        ("201", "geom.201.STL", False, 100),    # ground sheet unstitched
        ("949", "geom.949.STL", True, 0),       # clean city mesh
        ("950", "uDALES_shape.STL", False, 0),  # 2 open-bottom buildings
    ])
    def test_shipped_stls(self, case, stl, expect_valid, min_touch):
        p = Path(f"/root/reference/examples/{case}/{stl}")
        if not p.exists():
            pytest.skip("reference examples not present")
        r = check(UDGeom(path=p))
        assert r["valid"] == expect_valid, r["issues"]
        assert r["n_touching_regions"] >= min_touch
        if case in ("101", "950"):
            assert any("not watertight" in i for i in r["issues"])


# ---------------------------------------------------------------------------
# canonical generators (geometry_generation.py createCanyons/createCubes)
# ---------------------------------------------------------------------------

class TestGenerators:
    def test_flat_surface(self):
        g = create_flat_surface(64.0, 32.0, 8.0)
        assert g.total_area == pytest.approx(64.0 * 32.0)
        assert np.allclose(g.tris[..., 2], 0.0)
        assert g.n_faces == 2 * 8 * 4

    def test_single_cube(self):
        g = create_cubes(64.0, 64.0, 8.0, 8.0, 16.0, geom_option="S")
        bs = g.get_buildings()
        assert len(bs) == 1
        b = bs[0]
        assert np.allclose(b.bounds[0], [28.0, 28.0, 0.0])
        assert np.allclose(b.bounds[1], [36.0, 36.0, 16.0])
        assert check(g)["valid"]

    def test_aligned_array_lambda_p(self):
        g = create_cubes(128.0, 128.0, 16.0, 16.0, 32.0, 16.0, 16.0, "AC",
                         edgelength=16.0)
        bs = g.get_buildings()
        assert len(bs) == 16
        # lambda_p = built area / domain area = 0.25
        built = sum((b.bounds[1, 0] - b.bounds[0, 0])
                    * (b.bounds[1, 1] - b.bounds[0, 1]) for b in bs)
        assert built / (128.0 * 128.0) == pytest.approx(0.25)
        # ground covers domain minus footprints
        ground = g.identify_ground_faces()
        assert g.face_areas[ground].sum() == pytest.approx(
            128.0 * 128.0 - built)

    def test_staggered_rows_shifted(self):
        g = create_cubes(128.0, 128.0, 16.0, 16.0, 32.0, 16.0, 16.0, "SC",
                         edgelength=16.0)
        bs = g.get_buildings()
        ys = sorted({round(float(b.bounds[0, 1]), 3) for b in bs
                     if b.bounds[0, 0] < 32})
        ys2 = sorted({round(float(b.bounds[0, 1]), 3) for b in bs
                      if 32 < b.bounds[0, 0] < 64})
        # alternate columns shifted by half the y pitch
        assert ys and ys2 and ys != ys2
        assert check(g)["valid"]

    def test_canyons(self):
        g = create_canyons(128.0, 64.0, 16.0, 16.0, 32.0,
                           shift=0.0, edgelength=16.0)
        bs = g.get_buildings()
        assert len(bs) == 4
        for b in bs:
            # strips span the full y extent and height H
            assert b.bounds[0, 1] == 0.0 and b.bounds[1, 1] == 64.0
            assert b.bounds[1, 2] == 32.0
        assert check(g)["valid"]

    def test_canyons_rotate90(self):
        g = create_canyons(64.0, 64.0, 16.0, 16.0, 8.0, 0.0, 16.0,
                           rotate90=True)
        for b in g.get_buildings():
            # strips now run along x
            assert b.bounds[0, 0] == pytest.approx(0.0)
            assert b.bounds[1, 0] == pytest.approx(64.0)

    def test_domain_multiple_validation(self):
        with pytest.raises(ValueError, match="multiple"):
            create_cubes(100.0, 128.0, 16.0, 16.0, 32.0, 16.0, 16.0, "AC")
        with pytest.raises(ValueError, match="multiple"):
            create_canyons(100.0, 64.0, 16.0, 16.0, 32.0, 0.0, 16.0)
        with pytest.raises(ValueError, match="geom_option"):
            create_cubes(64.0, 64.0, 8.0, 8.0, 8.0, geom_option="XX")

    def test_matches_bench_footprints(self):
        """create_cubes('AC') reproduces the bench urban geometry
        (make_box_array_stl 4x4 frac=0.5): identical building boxes."""
        from udales_jax.prep.prep import make_box_array_stl
        import tempfile, os
        with tempfile.TemporaryDirectory() as d:
            arr = make_box_array_stl(os.path.join(d, "a.stl"),
                                     4, 4, 0.5, 32.0, 128.0, 128.0)
        a = UDGeom(arr).get_buildings()
        b = create_cubes(128.0, 128.0, 16.0, 16.0, 32.0, 16.0, 16.0,
                         "AC", edgelength=16.0).get_buildings()
        fa = sorted(tuple(np.round(x.bounds.ravel(), 6)) for x in a)
        fb = sorted(tuple(np.round(x.bounds.ravel(), 6)) for x in b)
        assert fa == fb
