"""DSP ops ported so far: the LoRa coding chain (`coding`), soft demapping
(`modem`), the spreading-code generators (`spreading`), the FIR family
and designs (`filters`), polyphase resampling (`resample`), the DDC and
VCO (`stream_math`), the DUC (`filters2`), the BER half of `measure`,
OFDM channel estimation and equalisation (`ofdm`), and the hardware
impairments (`impairments`). Like the reference's ``r4w_tpu.ops``, the
package exports its modules; `impairments` is imported here, as the
reference imports it."""

from r4w_tpu_torch.ops import impairments

__all__ = ["impairments"]
