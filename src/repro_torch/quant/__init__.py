"""BitNet-style quantization: fake-quant with STE + sub-byte packing."""
from repro_torch.quant import bitnet, packing
from repro_torch.quant.bitnet import (
    QuantizedTensor,
    bit_linear_serve,
    bit_linear_train,
    fake_quant_act,
    fake_quant_weight,
    pack_weight_ternary,
    quantize_act_int8,
    quantize_weight_ternary,
)
from repro_torch.quant.packing import pack, pack_2bit, pack_4bit, unpack, unpack_2bit, unpack_4bit
