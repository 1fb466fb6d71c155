from .ladder import (
    LadderState,
    PermLadderState,
    beta_ladder_alpha,
    beta_ladder_biased,
    beta_ladder_depolarizing,
    betas_depolarizing,
    betas_xyz,
    init_ladder,
    make_ladder_step,
    make_perm_ladder_step,
    perm_enter,
    perm_exit,
)
