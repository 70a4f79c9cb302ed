# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: ydb_table.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import ydb_operation_pb2 as ydb__operation__pb2
from . import ydb_value_pb2 as ydb__value__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0fydb_table.proto\x12\tYdb.Table\x1a\x13ydb_operation.proto\x1a\x0fydb_value.proto\"Q\n\x14\x43reateSessionRequest\x12\x39\n\x10operation_params\x18\x01 \x01(\x0b\x32\x1f.Ydb.Operations.OperationParams\"E\n\x15\x43reateSessionResponse\x12,\n\toperation\x18\x01 \x01(\x0b\x32\x19.Ydb.Operations.Operation\")\n\x13\x43reateSessionResult\x12\x12\n\nsession_id\x18\x01 \x01(\t\"e\n\x14\x44\x65leteSessionRequest\x12\x12\n\nsession_id\x18\x01 \x01(\t\x12\x39\n\x10operation_params\x18\x02 \x01(\x0b\x32\x1f.Ydb.Operations.OperationParams\"E\n\x15\x44\x65leteSessionResponse\x12,\n\toperation\x18\x01 \x01(\x0b\x32\x19.Ydb.Operations.Operation\"6\n\x12OnlineModeSettings\x12 \n\x18\x61llow_inconsistent_reads\x18\x01 \x01(\x08\"\x1a\n\x18SerializableModeSettings\"\xa3\x01\n\x13TransactionSettings\x12\x46\n\x17serializable_read_write\x18\x01 \x01(\x0b\x32#.Ydb.Table.SerializableModeSettingsH\x00\x12\x39\n\x10online_read_only\x18\x02 \x01(\x0b\x32\x1d.Ydb.Table.OnlineModeSettingsH\x00\x42\t\n\x07tx_mode\"{\n\x12TransactionControl\x12\x32\n\x08\x62\x65gin_tx\x18\x01 \x01(\x0b\x32\x1e.Ydb.Table.TransactionSettingsH\x00\x12\x0f\n\x05tx_id\x18\x02 \x01(\tH\x00\x12\x11\n\tcommit_tx\x18\n \x01(\x08\x42\r\n\x0btx_selector\"\x1d\n\x0fTransactionMeta\x12\n\n\x02id\x18\x01 \x01(\t\"2\n\x05Query\x12\x12\n\x08yql_text\x18\x01 \x01(\tH\x00\x12\x0c\n\x02id\x18\x02 \x01(\tH\x00\x42\x07\n\x05query\")\n\x10QueryCachePolicy\x12\x15\n\rkeep_in_cache\x18\x01 \x01(\x08\"\x81\x03\n\x17\x45xecuteDataQueryRequest\x12\x12\n\nsession_id\x18\x01 \x01(\t\x12\x31\n\ntx_control\x18\x02 \x01(\x0b\x32\x1d.Ydb.Table.TransactionControl\x12\x1f\n\x05query\x18\x03 \x01(\x0b\x32\x10.Ydb.Table.Query\x12\x46\n\nparameters\x18\x04 \x03(\x0b\x32\x32.Ydb.Table.ExecuteDataQueryRequest.ParametersEntry\x12\x37\n\x12query_cache_policy\x18\x05 \x01(\x0b\x32\x1b.Ydb.Table.QueryCachePolicy\x12\x39\n\x10operation_params\x18\x06 \x01(\x0b\x32\x1f.Ydb.Operations.OperationParams\x1a\x42\n\x0fParametersEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x1e\n\x05value\x18\x02 \x01(\x0b\x32\x0f.Ydb.TypedValue:\x02\x38\x01\"H\n\x18\x45xecuteDataQueryResponse\x12,\n\toperation\x18\x01 \x01(\x0b\x32\x19.Ydb.Operations.Operation\"f\n\x12\x45xecuteQueryResult\x12#\n\x0bresult_sets\x18\x01 \x03(\x0b\x32\x0e.Ydb.ResultSet\x12+\n\x07tx_meta\x18\x02 \x01(\x0b\x32\x1a.Ydb.Table.TransactionMeta\"|\n\x19\x45xecuteSchemeQueryRequest\x12\x12\n\nsession_id\x18\x01 \x01(\t\x12\x10\n\x08yql_text\x18\x02 \x01(\t\x12\x39\n\x10operation_params\x18\x03 \x01(\x0b\x32\x1f.Ydb.Operations.OperationParams\"J\n\x1a\x45xecuteSchemeQueryResponse\x12,\n\toperation\x18\x01 \x01(\x0b\x32\x19.Ydb.Operations.Operationb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'ydb_table_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _EXECUTEDATAQUERYREQUEST_PARAMETERSENTRY._options = None
  _EXECUTEDATAQUERYREQUEST_PARAMETERSENTRY._serialized_options = b'8\001'
  _CREATESESSIONREQUEST._serialized_start=68
  _CREATESESSIONREQUEST._serialized_end=149
  _CREATESESSIONRESPONSE._serialized_start=151
  _CREATESESSIONRESPONSE._serialized_end=220
  _CREATESESSIONRESULT._serialized_start=222
  _CREATESESSIONRESULT._serialized_end=263
  _DELETESESSIONREQUEST._serialized_start=265
  _DELETESESSIONREQUEST._serialized_end=366
  _DELETESESSIONRESPONSE._serialized_start=368
  _DELETESESSIONRESPONSE._serialized_end=437
  _ONLINEMODESETTINGS._serialized_start=439
  _ONLINEMODESETTINGS._serialized_end=493
  _SERIALIZABLEMODESETTINGS._serialized_start=495
  _SERIALIZABLEMODESETTINGS._serialized_end=521
  _TRANSACTIONSETTINGS._serialized_start=524
  _TRANSACTIONSETTINGS._serialized_end=687
  _TRANSACTIONCONTROL._serialized_start=689
  _TRANSACTIONCONTROL._serialized_end=812
  _TRANSACTIONMETA._serialized_start=814
  _TRANSACTIONMETA._serialized_end=843
  _QUERY._serialized_start=845
  _QUERY._serialized_end=895
  _QUERYCACHEPOLICY._serialized_start=897
  _QUERYCACHEPOLICY._serialized_end=938
  _EXECUTEDATAQUERYREQUEST._serialized_start=941
  _EXECUTEDATAQUERYREQUEST._serialized_end=1326
  _EXECUTEDATAQUERYREQUEST_PARAMETERSENTRY._serialized_start=1260
  _EXECUTEDATAQUERYREQUEST_PARAMETERSENTRY._serialized_end=1326
  _EXECUTEDATAQUERYRESPONSE._serialized_start=1328
  _EXECUTEDATAQUERYRESPONSE._serialized_end=1400
  _EXECUTEQUERYRESULT._serialized_start=1402
  _EXECUTEQUERYRESULT._serialized_end=1504
  _EXECUTESCHEMEQUERYREQUEST._serialized_start=1506
  _EXECUTESCHEMEQUERYREQUEST._serialized_end=1630
  _EXECUTESCHEMEQUERYRESPONSE._serialized_start=1632
  _EXECUTESCHEMEQUERYRESPONSE._serialized_end=1706
# @@protoc_insertion_point(module_scope)
