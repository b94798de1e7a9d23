"""Global numeric constants.

Parity source: the reference's template/common.h:8-13 and the per-renderer
epsilons (2. WhittedStyle/renderer.h:12, infra/bvh.cpp:203-222).
"""

import numpy as np

PI = np.float32(3.14159265358979323846264)
INVPI = np.float32(0.31830988618379067153777)
INV2PI = np.float32(0.15915494309189533576888)
TWOPI = np.float32(6.28318530717958647692528)
SQRT_PI_INV = np.float32(0.56418958355)
LARGE_FLOAT = np.float32(1e34)

# Ray-miss sentinel distance (template/ray.h:15 `distance = 1e34f`).
RAY_FAR = np.float32(1e34)
# AABB-miss sentinel used by slab tests (infra/bvh.cpp:190 returns 1e30f).
AABB_MISS = np.float32(1e30)
# Möller–Trumbore epsilon (infra/bvh.cpp:209 / :217).
TRI_EPS = np.float32(1e-4)
# Shading offset epsilon (2. WhittedStyle/renderer.h:12).
SHADE_EPS = np.float32(1e-3)

# Default render resolution of the reference (template/camera.h:4-5).
SCRWIDTH = 1024
SCRHEIGHT = 640

# Depth limit shared by both integrators (2. WhittedStyle/renderer.h:61,
# 3. PathTracer/renderer.h:53).
DEPTH_LIMIT = 5

# Index of refraction used by the dielectric branch in both integrators
# (2. WhittedStyle/renderer.cpp:57, 3. PathTracer/renderer.cpp:30).
IOR = np.float32(1.2)

# The scene's single light color (tlas_file_scene.cpp GetLightColor).
LIGHT_COLOR = (24.0, 24.0, 22.0)
# Whitted constant ambient term (2. WhittedStyle/renderer.cpp:77).
AMBIENT = (0.3, 0.3, 0.3)
