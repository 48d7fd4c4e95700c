"""Model library (port of smc_tpu/models): the linear-regression fixture and
its regime-switching variant, the closed-form regression, CAPM, the linear
DSGE container with An-Schorfheide and Smets-Wouters. Every name of
smc_tpu.models, plus load_sw_data."""

from smc_tpu_torch.models.linear import (
    linear_parameters,
    make_linear_loglike,
    generate_linear_data,
    rs_linear_parameters,
    make_rs_linear_loglike,
    generate_rs_linear_data,
)
from smc_tpu_torch.models.regression import (
    regression_parameters,
    make_regression_loglike,
    generate_regression_data,
)
from smc_tpu_torch.models.capm import (
    capm_parameters,
    make_capm_loglike,
    generate_capm_data,
)
from smc_tpu_torch.models.dsge import (
    LinearDSGE,
    solve_linear_re,
    kalman_loglike,
    lyapunov_doubling,
)
from smc_tpu_torch.models.as_dsge import (
    an_schorfheide,
    an_schorfheide_parameters,
    generate_as_data,
    TRUE_PARAMS as AS_TRUE_PARAMS,
)
from smc_tpu_torch.models.sw_dsge import (
    smets_wouters,
    sw_parameters,
    generate_sw_data,
    load_sw_data,
    TRUE_PARAMS as SW_TRUE_PARAMS,
)
