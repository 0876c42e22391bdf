"""Decoding (greedy, the CTC prefix-beam kernel K4, HMM Viterbi and forced
alignment), the CTC loss, n-gram tables and the other ops of the port."""
