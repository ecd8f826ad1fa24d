"""TFHE simulation layer: exact integer circuits + cost/parameter models."""

from repro_torch.fhe.circuits import (  # noqa: F401
    dotprod_attention_circuit,
    inhibitor_attention_circuit,
)
from repro_torch.fhe.cost import (  # noqa: F401
    circuit_seconds,
    describe,
    pbs_seconds,
)
from repro_torch.fhe.params import (  # noqa: F401
    TfheParams,
    select_params,
    select_params_for_report,
    select_params_static,
)
from repro_torch.fhe.tfhe_sim import (  # noqa: F401
    EncTensor,
    FheContext,
    decrypt,
    encrypt,
)
