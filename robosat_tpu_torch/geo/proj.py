"""Map projections used by the vector pipeline.

This package's copy of robosat_tpu/geo/proj.py: the same code over the port's
own modules, held to the original by tests/test_torch_port_geo.py.

Replaces the reference's pyproj/PROJ dependency (robosat/spatial/core.py:21,42-44)
with closed-form implementations of the three coordinate systems the pipeline
actually uses:

- EPSG:3857  spherical web mercator (tile rasterization transform)
- EPSG:3395  WGS84-ellipsoid world mercator in meters (merge buffering distances)
- ESRI:54009 world Mollweide, an equal-area projection (shape IoU and areas)

All functions are vectorized over numpy arrays of coordinates.
"""

import numpy as np

# WGS84 ellipsoid.
A = 6378137.0
F = 1.0 / 298.257223563
E2 = F * (2.0 - F)
E = np.sqrt(E2)


def wgs_to_webmercator(lng, lat):
    """EPSG:4326 degrees -> EPSG:3857 meters (spherical mercator)."""
    lng = np.asarray(lng, dtype=np.float64)
    lat = np.asarray(lat, dtype=np.float64)
    x = A * np.radians(lng)
    y = A * np.log(np.tan(np.pi / 4.0 + np.radians(lat) / 2.0))
    return x, y


def webmercator_to_wgs(x, y):
    """EPSG:3857 meters -> EPSG:4326 degrees."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    lng = np.degrees(x / A)
    lat = np.degrees(2.0 * np.arctan(np.exp(y / A)) - np.pi / 2.0)
    return lng, lat


def wgs_to_worldmercator(lng, lat):
    """EPSG:4326 degrees -> EPSG:3395 meters (ellipsoidal mercator).

    Standard series: x = a*lambda, y = a*ln(tan(pi/4 + phi/2) * ((1 - e sin phi)
    / (1 + e sin phi))^(e/2)).
    """
    lng = np.asarray(lng, dtype=np.float64)
    lat = np.asarray(lat, dtype=np.float64)
    phi = np.radians(lat)
    x = A * np.radians(lng)
    esin = E * np.sin(phi)
    y = A * np.log(np.tan(np.pi / 4.0 + phi / 2.0) * ((1.0 - esin) / (1.0 + esin)) ** (E / 2.0))
    return x, y


def worldmercator_to_wgs(x, y):
    """EPSG:3395 meters -> EPSG:4326 degrees (iterative inverse)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    lng = np.degrees(x / A)
    t = np.exp(-y / A)
    # Fixed-point iteration for the conformal latitude inverse; converges in a
    # handful of iterations to double precision.
    phi = np.pi / 2.0 - 2.0 * np.arctan(t)
    for _ in range(10):
        esin = E * np.sin(phi)
        phi = np.pi / 2.0 - 2.0 * np.arctan(t * ((1.0 - esin) / (1.0 + esin)) ** (E / 2.0))
    return lng, np.degrees(phi)


def wgs_to_mollweide(lng, lat):
    """EPSG:4326 degrees -> ESRI:54009 world Mollweide meters (equal-area).

    Solves 2*theta + sin(2*theta) = pi * sin(phi) by Newton iteration, then
    x = 2*sqrt(2)/pi * R * lambda * cos(theta), y = sqrt(2) * R * sin(theta),
    with R = the WGS84 semi-major axis (PROJ applies the spherical Mollweide
    formulas with R = a for this CRS).
    """
    lng = np.asarray(lng, dtype=np.float64)
    lat = np.asarray(lat, dtype=np.float64)
    lam = np.radians(lng)
    phi = np.radians(lat)

    k = np.pi * np.sin(phi)
    theta = phi.copy() if phi.ndim else np.array(phi, dtype=np.float64)
    theta = np.asarray(theta, dtype=np.float64)

    def newton(theta, iters):
        for _ in range(iters):
            twot = 2.0 * theta
            f = twot + np.sin(twot) - k
            fp = 2.0 + 2.0 * np.cos(twot)
            # Near the poles fp -> 0; clamp to keep Newton stable and rely on
            # the sin saturating at +-1 there.
            theta = theta - f / np.maximum(fp, 1e-12)
        return theta

    # Quadratic convergence reaches <1e-8 m by 8 steps everywhere the slippy
    # pipeline can produce coordinates (|lat| <= 85.06); only near-pole
    # inputs converge linearly and take the long tail. The iou hot loop
    # calls this per candidate pair, so the common case matters.
    theta = newton(theta, 8)
    twot = 2.0 * theta
    # PER-POINT long tail: the extra iterations must depend only on each
    # point's own residual — a collection-global any() would let one
    # slow-converging (near-pole) vertex re-iterate EVERY vertex in the
    # batch, perturbing already-converged coordinates by 1 ulp and making
    # batched projections (geometry.transform_multipolygons over a whole
    # feature collection) disagree with per-ring ones. An extra Newton step
    # from a converged theta is a fixed point only in exact arithmetic.
    need = np.abs(twot + np.sin(twot) - k) > 1e-12
    if np.any(need):
        theta = np.where(need, newton(theta, 17), theta)
    theta = np.clip(theta, -np.pi / 2.0, np.pi / 2.0)

    x = 2.0 * np.sqrt(2.0) / np.pi * A * lam * np.cos(theta)
    y = np.sqrt(2.0) * A * np.sin(theta)
    return x, y
