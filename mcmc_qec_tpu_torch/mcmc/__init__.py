from .ladder import (
    LadderState,
    beta_ladder_alpha,
    beta_ladder_biased,
    beta_ladder_depolarizing,
    betas_depolarizing,
    betas_xyz,
    init_ladder,
)
