from emap_tpu_torch.fields.embedder import pe_dim, positional_encoding
from emap_tpu_torch.fields.scalars import (
    beta_gamma_zeta,
    init_beta_params,
    init_variance_params,
    inv_s_value,
)
from emap_tpu_torch.fields.udf import (
    UDFConfig,
    apply_udf,
    init_udf_params,
    udf_gradient,
    udf_value,
    udf_value_and_gradient,
)

__all__ = [
    "pe_dim",
    "positional_encoding",
    "beta_gamma_zeta",
    "init_beta_params",
    "init_variance_params",
    "inv_s_value",
    "UDFConfig",
    "apply_udf",
    "init_udf_params",
    "udf_gradient",
    "udf_value",
    "udf_value_and_gradient",
]
