from .fasta import read_seqs, write_fasta, detect_format
from .seqdb import SeqDatabase, encode_seq, decode_seq, revcomp_codes

__all__ = [
    "read_seqs",
    "write_fasta",
    "detect_format",
    "SeqDatabase",
    "encode_seq",
    "decode_seq",
    "revcomp_codes",
]
