"""NetCDF ingestion tests: classic NetCDF3 via
scipy, NetCDF4/HDF5 via h5py, converter script, and the direct-``.nc`` path
through the climate pipeline."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from gb25_tpu.data.netcdf import (
    load_atmosphere_nc,
    load_bathymetry_nc,
    load_climatology_nc,
    read_netcdf,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_etopo_nc3(path, Na=36, Ma=18):
    """A tiny ETOPO1-like classic NetCDF file (int16 + scale, as real ETOPO)."""
    from scipy.io import netcdf_file

    lon = (np.arange(Na) + 0.5) * (360.0 / Na)
    lat = -90.0 + (np.arange(Ma) + 0.5) * (180.0 / Ma)
    z = -4000.0 + 3000.0 * np.exp(-((lon[:, None] - 180) ** 2 + (lat[None, :] * 2) ** 2) / 800.0)
    with netcdf_file(path, "w") as nc:
        nc.createDimension("lon", Na)
        nc.createDimension("lat", Ma)
        vlon = nc.createVariable("lon", "d", ("lon",)); vlon[:] = lon
        vlat = nc.createVariable("lat", "d", ("lat",)); vlat[:] = lat
        vz = nc.createVariable("z", "h", ("lat", "lon"))  # (lat, lon) like ETOPO
        vz[:] = np.round(z.T / 2.0).astype(np.int16)
        vz._attributes["scale_factor"] = 2.0
    return lon, lat, z


def _write_ecco_nc4(path, Na=24, Ma=12, L=5):
    """A tiny ECCO-like NetCDF4 (HDF5) file with (time, z, lat, lon) T/S."""
    import h5py

    lon = (np.arange(Na) + 0.5) * (360.0 / Na)
    lat = -60.0 + (np.arange(Ma) + 0.5) * (120.0 / Ma)
    zl = np.array([5.0, 50.0, 200.0, 1000.0, 3000.0])  # positive-down depths
    T = 20.0 * np.exp(-zl[None, :, None, None] / 800.0) + 0.01 * lat[None, None, :, None] + 0 * lon
    S = 35.0 + 0.0 * T
    with h5py.File(path, "w") as f:
        f["longitude"] = lon
        f["latitude"] = lat
        f["depth"] = zl
        f["THETA"] = np.repeat(T, 2, axis=0)  # 2 "months"
        f["SALT"] = np.repeat(S, 2, axis=0)
    return lon, lat, zl, T[0], S[0]


def _write_jra_nc3(path, Na=24, Ma=12, Nt=4):
    from scipy.io import netcdf_file

    lon = (np.arange(Na) + 0.5) * (360.0 / Na)
    lat = -90.0 + (np.arange(Ma) + 0.5) * (180.0 / Ma)
    times = np.arange(Nt) * 10800.0
    tas = 273.15 + 20 * np.cos(np.deg2rad(lat))[None, :, None] + 0 * lon[:, None, None] + 0 * times
    with netcdf_file(path, "w") as nc:
        nc.createDimension("lon", Na)
        nc.createDimension("lat", Ma)
        nc.createDimension("time", Nt)
        nc.createVariable("lon", "d", ("lon",))[:] = lon
        nc.createVariable("lat", "d", ("lat",))[:] = lat
        nc.createVariable("time", "d", ("time",))[:] = times
        v = nc.createVariable("tas", "d", ("time", "lat", "lon"))
        v[:] = np.transpose(np.broadcast_to(tas, (Na, Ma, Nt)), (2, 1, 0))
        u = nc.createVariable("uas", "d", ("time", "lat", "lon"))
        u[:] = 5.0
    return lon, lat, times


def test_read_netcdf3_with_cf_packing(tmp_path):
    p = str(tmp_path / "etopo.nc")
    lon, lat, z = _write_etopo_nc3(p)
    got_lon, got_lat, got_z = load_bathymetry_nc(p)
    np.testing.assert_allclose(got_lon, lon % 360.0)
    assert got_z.shape == (len(lon), len(lat))  # transposed to (lon, lat)
    # int16 + scale_factor=2 quantization: within 2 m
    np.testing.assert_allclose(got_z, z, atol=2.0)


def test_read_netcdf4_climatology(tmp_path):
    p = str(tmp_path / "ecco.nc")
    lon, lat, zl, T, S = _write_ecco_nc4(p)
    d = load_climatology_nc(p)
    assert d["T"].shape == (len(lon), len(lat), len(zl))
    assert (d["z_levels"] <= 0).all()  # depths converted to negative z
    np.testing.assert_allclose(d["T"][0, 0, :], T[:, 0, 0], rtol=1e-6)


def test_atmosphere_nc_and_defaults(tmp_path):
    p = str(tmp_path / "jra.nc")
    lon, lat, times = _write_jra_nc3(p)
    d = load_atmosphere_nc(p)
    assert d["Ta"].shape == (len(lon), len(lat), len(times))
    assert np.allclose(d["ua"], 5.0)
    assert np.allclose(d["pa"], 101325.0)  # missing -> default


def test_converter_script_and_npz_contract(tmp_path):
    nc = str(tmp_path / "etopo.nc")
    out = str(tmp_path / "bathymetry.npz")
    _write_etopo_nc3(nc)
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "convert_datasets.py"),
         "etopo1", nc, "-o", out],
        capture_output=True, text=True,
    )
    assert r.returncode == 0, r.stderr
    with np.load(out) as d:
        assert {"lon", "lat", "z"} <= set(d.keys())


def test_regrid_bathymetry_accepts_nc_directly(tmp_path):
    from gb25_tpu.data import regrid_bathymetry
    from gb25_tpu.grids import simple_latitude_longitude_grid

    nc = str(tmp_path / "etopo.nc")
    _write_etopo_nc3(nc)
    grid = simple_latitude_longitude_grid(24, 12, 4, dtype=jnp.float64)
    g2 = regrid_bathymetry(grid, nc)
    assert g2.immersed
    bh = np.asarray(g2.bottom_height)
    assert bh.min() < -3000.0 and bh.max() <= 0.0


def test_climate_script_runs_with_nc_inputs(tmp_path):
    """End-to-end: the reference's ocean_climate_simulation with NetCDF
    bathymetry + climatology + atmosphere inputs
    (simulations/ocean_climate_simulation.jl:61-83 analog)."""
    bathy = str(tmp_path / "etopo.nc")
    clim = str(tmp_path / "ecco.nc")
    atmos = str(tmp_path / "jra.nc")
    _write_etopo_nc3(bathy)
    _write_ecco_nc4(clim)
    _write_jra_nc3(atmos)
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "ocean_climate_simulation.py"),
         "--resolution", "16", "--Nz", "4", "--dt", "600", "--stop-days", "0.02",
         "--bathymetry", bathy, "--climatology", clim, "--atmosphere", atmos,
         "--output-dir", str(tmp_path / "out")],
        capture_output=True, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "done:" in r.stdout


def _write_era5_style_nc3(path, Na=24, Ma=12, Nt=3):
    """Byte-faithful ERA5-download quirks in one file: int16 packing with
    scale AND offset AND _FillValue, longitude in [-180, 180), latitude
    DESCENDING 90 -> -90, time as "hours since 1900-01-01"."""
    from scipy.io import netcdf_file

    lon = -180.0 + (np.arange(Na) + 0.5) * (360.0 / Na)          # [-180, 180)
    lat = (90.0 - (np.arange(Ma) + 0.5) * (180.0 / Ma))          # descending
    hours = 1_000_000.0 + np.arange(Nt) * 3.0                     # 3-hourly
    # ground truth on the canonical (ascending, [0,360)) axes
    lon_c = np.sort(lon % 360.0)
    lat_c = lat[::-1]
    truth = (273.15 + 20 * np.cos(np.deg2rad(lat_c))[None, :]
             + 5.0 * np.sin(np.deg2rad(lon_c))[:, None])          # (lon, lat)
    # encode on the FILE's axes (time, lat desc, lon [-180,180))
    remap = np.argsort(lon % 360.0)                               # canon->file? inverse:
    inv = np.empty_like(remap); inv[remap] = np.arange(Na)
    enc = truth[inv][:, ::-1]                                     # file-axis (lon, lat)
    scale, offset, fill = 0.01, 250.0, np.int16(-32767)
    packed = np.round((enc - offset) / scale).astype(np.int16)
    packed[0, 0] = fill                                           # one missing cell
    with netcdf_file(path, "w") as nc:
        nc.createDimension("longitude", Na)
        nc.createDimension("latitude", Ma)
        nc.createDimension("time", Nt)
        nc.createVariable("longitude", "d", ("longitude",))[:] = lon
        nc.createVariable("latitude", "d", ("latitude",))[:] = lat
        vt = nc.createVariable("time", "d", ("time",))
        vt[:] = hours
        vt._attributes["units"] = "hours since 1900-01-01 00:00:0.0"
        vt._attributes["calendar"] = "gregorian"
        v = nc.createVariable("t2m", "h", ("time", "latitude", "longitude"))
        v[:] = np.broadcast_to(packed.T[None], (Nt, Ma, Na))
        v._attributes["scale_factor"] = scale
        v._attributes["add_offset"] = offset
        v._attributes["_FillValue"] = fill
    return lon_c, lat_c, truth


def test_era5_quirks_canonicalized(tmp_path):
    """Descending lat + [-180,180) lon + packed shorts w/ offset + fill +
    CF hour units all land on the canonical axes with correct values."""
    p = str(tmp_path / "era5.nc")
    lon_c, lat_c, truth = _write_era5_style_nc3(p)
    d = load_atmosphere_nc(p)
    np.testing.assert_allclose(d["lon"], lon_c)
    np.testing.assert_allclose(d["lat"], lat_c)          # flipped ascending
    assert np.all(np.diff(d["lon"]) > 0)
    # CF time: hours -> seconds, relative to first record
    np.testing.assert_allclose(d["times"], [0.0, 10800.0, 21600.0])
    got = d["Ta"][:, :, 0]
    # the fill cell was replaced by the finite default, not the fill value
    mask = np.ones_like(got, bool)
    bad = np.argwhere(np.abs(got - truth) > 0.01)
    assert len(bad) <= 1                                  # only the fill cell
    for i, j in bad:
        mask[i, j] = False
        assert got[i, j] == 288.15                        # Ta default
    np.testing.assert_allclose(got[mask], truth[mask], atol=0.01)


def test_etopo_lon180_bathymetry_regrid(tmp_path):
    """ETOPO variant published on [-180,180): regrid must see an ascending
    axis (non-monotonic lon silently corrupts bilinear weights)."""
    from gb25_tpu.data import regrid_bathymetry
    from gb25_tpu.grids import simple_latitude_longitude_grid

    from scipy.io import netcdf_file

    p = str(tmp_path / "etopo180.nc")
    Na, Ma = 36, 18
    lon = -180.0 + (np.arange(Na) + 0.5) * (360.0 / Na)
    lat = -90.0 + (np.arange(Ma) + 0.5) * (180.0 / Ma)
    # deep everywhere except a seamount at lon ~ +90E (canonical 90.0)
    z = np.full((Na, Ma), -4000.0)
    z[np.argmin(np.abs(lon - 90.0)), :] = -100.0
    with netcdf_file(p, "w") as nc:
        nc.createDimension("lon", Na)
        nc.createDimension("lat", Ma)
        nc.createVariable("lon", "d", ("lon",))[:] = lon
        nc.createVariable("lat", "d", ("lat",))[:] = lat
        vz = nc.createVariable("z", "h", ("lat", "lon"))
        vz[:] = z.T.astype(np.int16)
    got_lon, got_lat, got_z = load_bathymetry_nc(p)
    assert np.all(np.diff(got_lon) > 0) and got_lon.min() >= 0.0
    i90 = np.argmin(np.abs(got_lon - 90.0))
    assert got_z[i90, 0] == -100.0                       # seamount at 90E
    grid = simple_latitude_longitude_grid(24, 12, 4, dtype=jnp.float64)
    g2 = regrid_bathymetry(grid, p)
    bh = np.asarray(g2.bottom_height)
    ic = np.argmin(np.abs(np.asarray(grid.lam_c_i) - 90.0))
    iw = np.argmin(np.abs(np.asarray(grid.lam_c_i) - 270.0))
    assert bh[ic].max() > -2100.0                        # shallows at 90E...
    assert bh[iw].max() < -3000.0                        # ...not aliased to 270E


def test_etopo_grid_registered_duplicate_endpoint(tmp_path):
    """Grid-registered ETOPO (*_g_gmt4: lon = -180..180 INCLUSIVE) carries
    both endpoints of the same meridian; the duplicate must be dropped, not
    rejected (docs/DATA.md's one-command recipe downloads exactly this)."""
    from scipy.io import netcdf_file

    p = str(tmp_path / "etopo_g.nc")
    Na, Ma = 37, 18  # 37 lon points: -180, -170, ..., 170, 180
    lon = np.linspace(-180.0, 180.0, Na)
    lat = -90.0 + (np.arange(Ma) + 0.5) * (180.0 / Ma)
    z = np.full((Na, Ma), -4000.0)
    z[np.argmin(np.abs(lon - 90.0)), :] = -100.0
    z[0, :] = -50.0   # the -180 row...
    z[-1, :] = -50.0  # ...and its +180 alias carry the same physics
    with netcdf_file(p, "w") as nc:
        nc.createDimension("lon", Na)
        nc.createDimension("lat", Ma)
        nc.createVariable("lon", "d", ("lon",))[:] = lon
        nc.createVariable("lat", "d", ("lat",))[:] = lat
        vz = nc.createVariable("z", "h", ("lat", "lon"))
        vz[:] = z.T.astype(np.int16)
    got_lon, got_lat, got_z = load_bathymetry_nc(p)
    assert len(got_lon) == Na - 1                       # duplicate dropped
    assert np.all(np.diff(got_lon) > 0) and got_lon.min() >= 0.0
    assert got_z.shape[0] == Na - 1                     # fields stay aligned
    i90 = np.argmin(np.abs(got_lon - 90.0))
    assert got_z[i90, 0] == -100.0
    i180 = np.argmin(np.abs(got_lon - 180.0))
    assert got_z[i180, 0] == -50.0


def test_parse_time_units_empty_axis():
    """A zero-record unlimited time axis (file created but never appended)
    must come back empty, not crash on t[0]."""
    from gb25_tpu.data.netcdf import parse_time_units

    out = parse_time_units(np.array([]), "hours since 1958-01-01")
    assert out.shape == (0,)


def test_writer_static_after_append_raises(tmp_path):
    """write() after the first append() must raise: the static section was
    already laid out (zero-filled), so the data would be silently lost."""
    from gb25_tpu.data.netcdf import NetCDF3Writer, read_netcdf

    p = str(tmp_path / "w.nc")
    w = NetCDF3Writer(p, {"time": None, "lat": 4})
    w.define("lat", ("lat",), np.float64)
    w.define("sst", ("time", "lat"), np.float32)
    w.append(sst=np.arange(4, dtype=np.float32))
    with pytest.raises(RuntimeError, match="header already written"):
        w.write("lat", np.arange(4.0))
    w.close()
    variables, _, _ = read_netcdf(p)
    assert variables["sst"].shape == (1, 4)
