from .pteq import PTEQ, PTEQConfig, PTEQResult, pteq_run
from .stdc import (
    STDC,
    STDC_general_noise,
    STDC_general_noise_shortest,
    STDC_Nall_n_alpha,
    stdc_run,
)
from .strc import STRC
