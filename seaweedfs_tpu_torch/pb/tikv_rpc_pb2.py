# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: tikv_rpc.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import tikv_kvrpc_pb2 as tikv__kvrpc__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0etikv_rpc.proto\x12\x06tikvpb\x1a\x10tikv_kvrpc.proto2\xdb\x02\n\x04Tikv\x12;\n\x06RawGet\x12\x16.kvrpcpb.RawGetRequest\x1a\x17.kvrpcpb.RawGetResponse\"\x00\x12;\n\x06RawPut\x12\x16.kvrpcpb.RawPutRequest\x1a\x17.kvrpcpb.RawPutResponse\"\x00\x12\x44\n\tRawDelete\x12\x19.kvrpcpb.RawDeleteRequest\x1a\x1a.kvrpcpb.RawDeleteResponse\"\x00\x12>\n\x07RawScan\x12\x17.kvrpcpb.RawScanRequest\x1a\x18.kvrpcpb.RawScanResponse\"\x00\x12S\n\x0eRawDeleteRange\x12\x1e.kvrpcpb.RawDeleteRangeRequest\x1a\x1f.kvrpcpb.RawDeleteRangeResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'tikv_rpc_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TIKV._serialized_start=45
  _TIKV._serialized_end=392
# @@protoc_insertion_point(module_scope)
