"""DSP ops ported so far: the LoRa coding chain (`coding`), soft demapping
(`modem`), LFSR sequences (`spreading`), the FIR family and designs
(`filters`), polyphase resampling (`resample`), the DDC and VCO
(`stream_math`) and the DUC (`filters2`)."""
