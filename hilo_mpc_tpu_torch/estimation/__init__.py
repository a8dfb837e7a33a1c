"""State and parameter estimation: moving-horizon estimation on the port's
interior point (its Newton steps on the Riccati kernels' free-x0 mode), the
Kalman filters and the particle filter."""
from .kf import ExtendedKalmanFilter, KalmanFilter, UnscentedKalmanFilter
from .mhe import MovingHorizonEstimator
from .pf import ParticleFilter
