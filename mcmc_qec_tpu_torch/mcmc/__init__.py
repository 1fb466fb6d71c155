from .ladder import (
    LadderState,
    beta_ladder_depolarizing,
    betas_depolarizing,
    betas_xyz,
    init_ladder,
)
