from .solver import OracleInfo, OracleResult, OracleSolver

__all__ = ["OracleSolver", "OracleResult", "OracleInfo"]
