from .units import parse_quantity, format_quantity, parse_cpu_millis, parse_mem_mib

__all__ = ["parse_quantity", "format_quantity", "parse_cpu_millis", "parse_mem_mib"]
