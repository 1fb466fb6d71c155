from .pteq import PTEQ, PTEQConfig, PTEQResult, pteq_run
