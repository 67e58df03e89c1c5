"""DSP ops ported so far: the LoRa coding chain (`coding`), soft demapping
(`modem`), the spreading-code generators (`spreading`), the FIR family
and designs (`filters`), polyphase resampling (`resample`), the DDC and
VCO (`stream_math`), the DUC (`filters2`), the BER half of `measure`, and
OFDM channel estimation and equalisation (`ofdm`)."""
