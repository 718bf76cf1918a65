from .vcn import VCN, VCNSmall, vcn, vcn_small  # noqa: F401
