from .floatbits import bits_to_int, calc_bit_count, logits_to_noc, \
    logits_to_noc_with_gt, noc_to_bits, noc_to_nn_target
