from .floatbits import bits_to_int, calc_bit_count, logits_to_noc, noc_to_bits
