"""Example systems of the PyTorch port (counterpart of ``tinympc_tpu.systems``).

The port keeps its own copies of the fixtures it runs, so it never reads the
JAX package's data module. Each accessor returns a dict of numpy arrays with
the keys of the JAX package's accessors: A (nx,nx), B (nx,nu), f (nx,),
Qdiag (nx,), Rdiag (nu,), rho -- the arguments of
:func:`tinympc_tpu_torch.setup`.
"""
from __future__ import annotations

import numpy as np

# Crazyflie quadrotor, 20 Hz discretisation (the reference's
# examples/problem_data/quadrotor_20hz_params.hpp), row-major.
_QUAD20_A = [
    1.0, 0.0, 0.0, 0.0, 0.024525, 0.0, 0.05, 0.0, 0.0, 0.0, 0.0002044, 0.0,
    0.0, 1.0, 0.0, -0.024525, 0.0, 0.0, 0.0, 0.05, 0.0, -0.0002044, 0.0, 0.0,
    0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.05, 0.0, 0.0, 0.0,
    0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.025, 0.0, 0.0,
    0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.025, 0.0,
    0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.025,
    0.0, 0.0, 0.0, 0.0, 0.981, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0122625, 0.0,
    0.0, 0.0, 0.0, -0.981, 0.0, 0.0, 0.0, 1.0, 0.0, -0.0122625, 0.0, 0.0,
    0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0,
    0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0,
    0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0,
    0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0,
]
_QUAD20_B = [
    -0.0007069, 0.0007773, 0.0007091, -0.0007795,
    0.0007034, 0.0007747, -0.0007042, -0.0007739,
    0.0052554, 0.0052554, 0.0052554, 0.0052554,
    -0.1720966, -0.1895213, 0.1722891, 0.1893288,
    -0.1729419, 0.190174, 0.1734809, -0.1907131,
    0.0123423, -0.0045148, -0.0174024, 0.0095748,
    -0.056552, 0.0621869, 0.0567283, -0.0623632,
    0.0562756, 0.0619735, -0.0563386, -0.0619105,
    0.2102143, 0.2102143, 0.2102143, 0.2102143,
    -13.7677303, -15.1617018, 13.7831318, 15.1463003,
    -13.8353509, 15.2139209, 13.8784751, -15.2570451,
    0.9873856, -0.361182, -1.392188, 0.7659845,
]
_QUAD20_Q = [100.0, 100.0, 100.0, 4.0, 4.0, 400.0, 4.0, 4.0, 4.0,
             2.0408163, 2.0408163, 4.0]
_QUAD20_R = [4.0, 4.0, 4.0, 4.0]

# Crazyflie quadrotor, 50 Hz discretisation (the reference's
# examples/problem_data/quadrotor_50hz_params.hpp), row-major; the same
# cost weights as at 20 Hz.
_QUAD50_A = [
    1.0, 0.0, 0.0, 0.0, 0.003924, -0.0, 0.02, 0.0, 0.0, 0.0, 1.31e-05, -0.0,
    0.0, 1.0, 0.0, -0.003924, 0.0, -0.0, 0.0, 0.02, 0.0, -1.31e-05, 0.0, -0.0,
    0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.02, 0.0, 0.0, 0.0,
    0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.01, -0.0, 0.0,
    0.0, 0.0, 0.0, -0.0, 1.0, -0.0, 0.0, 0.0, 0.0, 0.0, 0.01, -0.0,
    0.0, 0.0, 0.0, -0.0, 0.0, 1.0, 0.0, 0.0, 0.0, -0.0, 0.0, 0.01,
    0.0, 0.0, 0.0, 0.0, 0.3924, -0.0, 1.0, 0.0, 0.0, 0.0, 0.001962, -0.0,
    0.0, 0.0, 0.0, -0.3924, 0.0, -0.0, 0.0, 1.0, 0.0, -0.001962, 0.0, -0.0,
    0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0,
    0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, -0.0, 0.0,
    0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, -0.0,
    0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, -0.0, 0.0, 1.0,
]
_QUAD50_B = [
    -1.81e-05, 1.99e-05, 1.82e-05, -2e-05,
    1.8e-05, 1.98e-05, -1.8e-05, -1.98e-05,
    0.0008409, 0.0008409, 0.0008409, 0.0008409,
    -0.0275355, -0.0303234, 0.0275663, 0.0302926,
    -0.0276707, 0.0304278, 0.027757, -0.0305141,
    0.0019748, -0.0007224, -0.0027844, 0.001532,
    -0.0036193, 0.00398, 0.0036306, -0.0039912,
    0.0036016, 0.0039663, -0.0036057, -0.0039623,
    0.0840857, 0.0840857, 0.0840857, 0.0840857,
    -5.5070921, -6.0646807, 5.5132527, 6.0585201,
    -5.5341404, 6.0855684, 5.55139, -6.102818,
    0.3949542, -0.1444728, -0.5568752, 0.3063938,
]

# Rocket soft landing, 20 Hz (the reference's
# examples/problem_data/rocket_landing_params_20hz.hpp): state (position,
# velocity) in 3-D, thrust input, and gravity as the affine term f. The
# values are the float32 numbers of the header, widened.
_DT = 0.05000000074505806
_ROCKET_B2 = 0.0001250000059371814
_ROCKET_BV = 0.004999999888241291
_ROCKET_F = [0.0, 0.0, -0.012262499891221523, 0.0, 0.0, -0.49050000309944153]


def cartpole() -> dict:
    """4-state cart-pole (reference examples/cartpole_example.cpp:34-37)."""
    return dict(
        A=np.array([[1.0, 0.01, 0.0, 0.0],
                    [0.0, 1.0, 0.039, 0.0],
                    [0.0, 0.0, 1.002, 0.01],
                    [0.0, 0.0, 0.458, 1.002]]),
        B=np.array([[0.0], [0.02], [0.0], [0.067]]),
        f=np.zeros(4),
        Qdiag=np.array([10.0, 1.0, 10.0, 1.0]),
        Rdiag=np.array([1.0]),
        rho=1.0,
    )


def quadrotor_20hz() -> dict:
    """Crazyflie quadrotor, 20 Hz discretisation (nx=12, nu=4, rho=5)."""
    return dict(
        A=np.asarray(_QUAD20_A, np.float64).reshape(12, 12),
        B=np.asarray(_QUAD20_B, np.float64).reshape(12, 4),
        f=np.zeros(12),
        Qdiag=np.asarray(_QUAD20_Q, np.float64),
        Rdiag=np.asarray(_QUAD20_R, np.float64),
        rho=5.0,
    )


def quadrotor_50hz() -> dict:
    """Crazyflie quadrotor, 50 Hz discretisation (nx=12, nu=4, rho=5), the
    system of the two hyperplane demos."""
    return dict(
        A=np.asarray(_QUAD50_A, np.float64).reshape(12, 12),
        B=np.asarray(_QUAD50_B, np.float64).reshape(12, 4),
        f=np.zeros(12),
        Qdiag=np.asarray(_QUAD20_Q, np.float64),
        Rdiag=np.asarray(_QUAD20_R, np.float64),
        rho=5.0,
    )


def rocket_landing_20hz() -> dict:
    """6-state rocket soft landing with the gravity affine term f (nx=6,
    nu=3, rho=1): double integrators in x, y, z."""
    A = np.eye(6)
    A[0, 3] = A[1, 4] = A[2, 5] = _DT
    B = np.zeros((6, 3))
    for k in range(3):
        B[k, k] = _ROCKET_B2
        B[3 + k, k] = _ROCKET_BV
    return dict(A=A, B=B, f=np.asarray(_ROCKET_F, np.float64),
                Qdiag=np.full(6, 101.0), Rdiag=np.full(3, 2.0), rho=1.0)
