from .exact import exact_mld, orbit
from .pteq import (
    PTEQ,
    PTEQ_alpha,
    PTEQ_alpha_with_shortest,
    PTEQ_biased,
    PTEQConfig,
    PTEQResult,
    pteq_run,
)
from .ptdc import PTDC, PTRC
from .single_temp import single_temp
from .stdc import (
    STDC,
    STDC_general_noise,
    STDC_general_noise_shortest,
    STDC_Nall_n_alpha,
    stdc_run,
)
from .strc import STRC
