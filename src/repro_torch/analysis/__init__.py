from .roofline import RooflineTerms, model_flops, roofline_from_record, roofline_table

__all__ = ["RooflineTerms", "model_flops", "roofline_from_record", "roofline_table"]
