"""Workflow analysis steps."""

from .expert_knowledge import ExpertKnowledgeAdapter

__all__ = ["ExpertKnowledgeAdapter"]
