"""Physical and geodetic constants.

RE matches the reference (models/sphharmlag.py:9, models/radbasfun.py:10).
WGS-84 parameters match pymap3d's Ellipsoid('wgs84'), which the reference
uses through pymap3d.geodetic2ecef/ecef2geodetic (interpolate.py:422,
models/sphharmlag.py:345,351).
"""

RE = 6371.2 * 1000.0  # Earth radius used by the cap model (m)

# WGS-84 ellipsoid
WGS84_A = 6378137.0  # semi-major axis (m)
WGS84_F = 1.0 / 298.257223563  # flattening
WGS84_B = WGS84_A * (1.0 - WGS84_F)  # semi-minor axis (m)
WGS84_E2 = 1.0 - (WGS84_B / WGS84_A) ** 2  # first eccentricity squared
WGS84_EP2 = (WGS84_A / WGS84_B) ** 2 - 1.0  # second eccentricity squared
