"""WGS84 <-> local transverse-Mercator coordinates, GDAL-free.

Re-implements the reference's GeoCoord (reference src/geo_coord/
geo_coord.cpp:32-153), which builds a custom Transverse Mercator PROJCS
centered on the survey origin via OGR. Here the projection is the
ellipsoidal transverse Mercator evaluated directly with Karney's 6th-order
Krueger series (sub-millimeter accuracy within any survey footprint), so
no GDAL dependency is needed; getWKT() emits the same WKT string for
GeoTIFF export.
"""

from __future__ import annotations

import numpy as np

WGS84_A = 6378137.0
WGS84_INV_F = 298.257223563


class GeoCoord:
    def __init__(self):
        self._initialized = False
        self._lat0 = float("nan")
        self._lon0 = float("nan")

    # --- series setup -----------------------------------------------------
    def set_origin(self, latitude: float, longitude: float) -> bool:
        f = 1.0 / WGS84_INV_F
        n = f / (2.0 - f)
        self._n = n
        self._A = (
            WGS84_A
            / (1 + n)
            * (1 + n**2 / 4 + n**4 / 64 + n**6 / 256)
        )
        # Karney (2011) alpha/beta coefficients to 6th order in n
        self._alpha = np.array(
            [
                n / 2 - 2 * n**2 / 3 + 5 * n**3 / 16 + 41 * n**4 / 180
                - 127 * n**5 / 288 + 7891 * n**6 / 37800,
                13 * n**2 / 48 - 3 * n**3 / 5 + 557 * n**4 / 1440
                + 281 * n**5 / 630 - 1983433 * n**6 / 1935360,
                61 * n**3 / 240 - 103 * n**4 / 140 + 15061 * n**5 / 26880
                + 167603 * n**6 / 181440,
                49561 * n**4 / 161280 - 179 * n**5 / 168 + 6601661 * n**6 / 7257600,
                34729 * n**5 / 80640 - 3418889 * n**6 / 1995840,
                212378941 * n**6 / 319334400,
            ]
        )
        self._beta = np.array(
            [
                n / 2 - 2 * n**2 / 3 + 37 * n**3 / 96 - n**4 / 360
                - 81 * n**5 / 512 + 96199 * n**6 / 604800,
                n**2 / 48 + n**3 / 15 - 437 * n**4 / 1440 + 46 * n**5 / 105
                - 1118711 * n**6 / 3870720,
                17 * n**3 / 480 - 37 * n**4 / 840 - 209 * n**5 / 4480
                + 5569 * n**6 / 90720,
                4397 * n**4 / 161280 - 11 * n**5 / 504 - 830251 * n**6 / 7257600,
                4583 * n**5 / 161280 - 108847 * n**6 / 3991680,
                20648693 * n**6 / 638668800,
            ]
        )
        self._e = np.sqrt(f * (2 - f))
        self._lat0 = latitude
        self._lon0 = longitude
        # northing of the origin latitude on the central meridian
        self._m0 = 0.0
        self._m0 = self._project(latitude, longitude)[1]
        self._initialized = True
        return True

    def is_initialized(self) -> bool:
        return self._initialized

    @property
    def origin(self):
        return self._lat0, self._lon0

    # --- forward ----------------------------------------------------------
    def _project(self, lat, lon):
        """degrees -> (easting, northing) without origin northing offset."""
        lat = np.deg2rad(np.asarray(lat, np.float64))
        lon = np.deg2rad(np.asarray(lon, np.float64)) - np.deg2rad(self._lon0)
        e = self._e
        sphi = np.sin(lat)
        t = np.sinh(
            np.arctanh(sphi) - e * np.arctanh(e * sphi)
        )
        xi_p = np.arctan2(t, np.cos(lon))
        eta_p = np.arcsinh(np.sin(lon) / np.sqrt(t * t + np.cos(lon) ** 2))
        j = np.arange(1, 7)
        xi = xi_p + np.sum(
            self._alpha * np.sin(2 * j * xi_p[..., None]) * np.cosh(2 * j * eta_p[..., None]),
            axis=-1,
        )
        eta = eta_p + np.sum(
            self._alpha * np.cos(2 * j * xi_p[..., None]) * np.sinh(2 * j * eta_p[..., None]),
            axis=-1,
        )
        return self._A * eta, self._A * xi

    def to_local(self, latitude, longitude, altitude=0.0):
        """(lat, lon, alt) degrees/meters -> local [x_east, y_north, z]."""
        if not self._initialized:
            return np.full(3, np.nan)
        x, y = self._project(latitude, longitude)
        return np.stack(
            [x, y - self._m0, np.asarray(altitude, np.float64)], axis=-1
        )

    # --- inverse ----------------------------------------------------------
    def to_wgs84(self, local):
        """local [x, y, z] -> (lat, lon, alt) degrees/meters."""
        if not self._initialized:
            return np.full(3, np.nan)
        local = np.asarray(local, np.float64)
        x = local[..., 0]
        y = local[..., 1] + self._m0
        eta = x / self._A
        xi = y / self._A
        j = np.arange(1, 7)
        xi_p = xi - np.sum(
            self._beta * np.sin(2 * j * xi[..., None]) * np.cosh(2 * j * eta[..., None]),
            axis=-1,
        )
        eta_p = eta - np.sum(
            self._beta * np.cos(2 * j * xi[..., None]) * np.sinh(2 * j * eta[..., None]),
            axis=-1,
        )
        chi = np.arcsin(np.sin(xi_p) / np.cosh(eta_p))  # conformal latitude
        # Newton iterations for geodetic latitude from conformal latitude
        e = self._e
        phi = chi
        for _ in range(5):
            sphi = np.sin(phi)
            t = np.sinh(np.arctanh(sphi) - e * np.arctanh(e * sphi))
            tc = np.tan(chi)
            # f(phi) = t - tan(chi); df/dphi
            dt = (
                np.sqrt(1 + t * t)
                * (1 - e * e)
                / ((1 - (e * sphi) ** 2) * np.cos(phi))
            )
            phi = phi - (t - tc) / dt
        lon = np.arctan2(np.sinh(eta_p), np.cos(xi_p))
        lat_deg = np.rad2deg(phi)
        lon_deg = np.rad2deg(lon) + self._lon0
        return np.stack([lat_deg, lon_deg, local[..., 2]], axis=-1)

    # --- WKT (same PROJCS the reference writes, geo_coord.cpp:43-67) ------
    def get_wkt(self) -> str:
        if not self._initialized:
            return "UNKNOWN"
        return (
            'PROJCS["Custom Transverse Mercator",\n'
            '    GEOGCS["WGS 84",\n'
            '        DATUM["WGS_1984",\n'
            '            SPHEROID["WGS 84",6378137,298.257223563,\n'
            '                AUTHORITY["EPSG","7030"]],\n'
            '            AUTHORITY["EPSG","6326"]],\n'
            '        PRIMEM["Greenwich",0,\n'
            '            AUTHORITY["EPSG","8901"]],\n'
            '        UNIT["degree",0.0174532925199433,\n'
            '            AUTHORITY["EPSG","9122"]],\n'
            '        AUTHORITY["EPSG","4326"]],\n'
            '    PROJECTION["Transverse_Mercator"],\n'
            f'    PARAMETER["latitude_of_origin",{self._lat0}],\n'
            f'    PARAMETER["central_meridian",{self._lon0}],\n'
            '    PARAMETER["scale_factor",1],\n'
            '    PARAMETER["false_easting",0],\n'
            '    PARAMETER["false_northing",0],\n'
            '    UNIT["metre",1,\n'
            '        AUTHORITY["EPSG","9001"]],\n'
            '    AXIS["Easting",EAST],\n'
            '    AXIS["Northing",NORTH]]'
        )
