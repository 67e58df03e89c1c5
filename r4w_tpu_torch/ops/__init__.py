"""DSP ops ported so far: the LoRa coding chain (`coding`)."""
