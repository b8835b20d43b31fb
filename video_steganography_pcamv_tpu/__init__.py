"""video_steganography_pcamv_tpu — JAX rebuild of the PCAMV/RCA
motion-vector video-steganography framework.

The reference (`lijun9250lj/video-steganography-PCAMV`) is an x264-b66 fork
that hides a message in the LSBs of P-frame motion vectors using
syndrome-trellis codes (STC), with a rate-distortion "cost assignment"
(RCA) that prefers flipping MVs whose perturbation is cheap and preserves
local optimality (see /root/reference/encoder/analyse.c:2391-2550 and
/root/reference/encoder/encoder.c:1276-1862).

This package is a from-scratch device-first design:

- Device compute path (JAX / XLA, one Pallas kernel): whole-frame batched pixel
  metrics, integer DCT/quant/recon in coefficient-plane layout, intra
  prediction, motion compensation, batched motion search, and the stego
  alternative-MV cost assignment.
- Host path (C++ / Python): bit-exact serial parts — CAVLC/bitstream
  writers, NAL, STC Viterbi, file I/O.
- Analysis is a pure function of the input frame + reference frame, so the
  reference's two-pass "encode, embed, re-encode" trick
  (/root/reference/encoder/encoder.c:2380-2390) collapses into
  analyse -> embed -> single final encode, with pass-consistency by
  construction.
"""

__version__ = "0.1.0"
