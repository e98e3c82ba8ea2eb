"""Treecode parameter sets used in the paper's experiments (Sec. 4)."""
from repro_torch.core.api import TreecodeConfig

# Fig. 4: single GPU vs 6-core CPU, 1e6 particles, N_B = N_L = 2000,
# MAC theta in {0.5, 0.7, 0.9}, degree n = 1..14.
FIG4 = tuple(
    TreecodeConfig(theta=theta, degree=n, leaf_size=2000, kernel="coulomb")
    for theta in (0.5, 0.7, 0.9) for n in range(1, 15)
)

# Fig. 5/6 weak+strong scaling: theta = 0.8, n = 8, N_B = N_L = 4000
# (5-6 digit accuracy).
SCALING = TreecodeConfig(theta=0.8, degree=8, leaf_size=4000,
                         kernel="coulomb")
SCALING_YUKAWA = TreecodeConfig(theta=0.8, degree=8, leaf_size=4000,
                                kernel="yukawa",
                                kernel_params={"kappa": 0.5})


def fig4(theta: float, degree: int) -> TreecodeConfig:
    """The FIG4 entry with this (theta, degree)."""
    for cfg in FIG4:
        if cfg.theta == theta and cfg.degree == degree:
            return cfg
    raise KeyError(f"FIG4 has no theta={theta}, degree={degree}")
