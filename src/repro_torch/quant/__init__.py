"""Port of ``repro.quant``."""
from repro_torch.quant.quantizer import (  # noqa: F401
    QuantSpec,
    quant_range,
    quant_params,
    quantize,
    dequantize,
    fake_quant_ref,
    from_qtensor,
    to_qtensor,
)
from repro_torch.quant.fake_quant import fake_quant, fake_quant_ste  # noqa: F401
from repro_torch.quant.noise import (  # noqa: F401
    expected_noise_tree, noise_power, quant_step)
from repro_torch.quant.policy import (  # noqa: F401
    BitConfig, QuantPolicy, random_bit_config)
from repro_torch.quant.calibration import EmaObserver, MinMaxObserver  # noqa: F401
